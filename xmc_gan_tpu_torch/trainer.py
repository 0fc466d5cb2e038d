"""Training orchestration (port of ``xmc_gan_tpu/trainer.py``): the frozen
text-encoder forward and the ``Trainer`` loop around ``train.make_train_step``.

Layout parity with the reference (``train_gan.py:140-335,400-499``) and the
JAX package:

* output dirs ``{output_root}/{DATASET_NAME}{SIZE}_{CONFIG_NAME}_{seed}/
  {img,log,model}`` (``train_gan.py:416-425``);
* ``sents.txt`` + ``imgs.png`` + per-epoch fixed-noise ``fake_samples_epoch_
  {e:03d}.png`` grids (``:146-160,323-326``), and ``fake_samples_{step:03d}
  .png`` every ``LOG_INTERVAL`` steps;
* a console line every ``N_CRITIC`` steps of the persisted step counter,
  per-epoch scalars (the last step's values, a reference quirk kept
  deliberately, ``:292-321``) plus images/s;
* checkpoints every epoch once ``epoch > save_after`` (reference: 50), then
  FID (``:328-334``);
* step-indexed auto-checkpoints (``model/auto``, the newest 2 kept), exact
  mid-epoch resume and SIGTERM preemption, as in the JAX package.

One process on one card (``device`` default ``cuda``; the CPU only when
asked), or one of a data-parallel group (``mesh``, a ``parallel.Mesh``: one
process per card, JAX ``trainer.py:143-185, 440-520, 700-715``): the loaders
give each rank its shard of every global batch of ``TRAIN.BATCH_SIZE``
rows, ``step_noise`` its rows of the global noise, the state is broadcast
from rank 0 at the start and after a restore, and the step keeps the ranks
equal (``train.make_train_step``).  Rank 0 alone makes the directories and
writes checkpoints, grids and logs; the others wait at a barrier after each
checkpoint.  Every rank runs every grid and FID eval (G's BatchNorm and the
FID statistics are collectives), and the SIGTERM flag is OR-reduced over the
ranks at each window boundary, so that all save and stop together.  Where
the port differs from the JAX ``Trainer``:

* G's noise is drawn on the host by ``Trainer.step_noise(global_step)``, a
  ``torch.Generator`` seeded from ``(seed, global_step)``, and moved to the
  card: a pure function of the step, so resume stays exact (JAX:
  ``fold_in(PRNGKey(seed + 7), step)``).  The images therefore differ from
  the JAX package's for one seed.
* ``steps_per_dispatch`` K runs windows of K single steps (PyTorch has no
  ``lax.scan``; the JAX numerics are the single step's too).  The windows
  still bound auto-saves and preemption.
* Each step's metrics stay 0-d tensors on the card and are read after the
  next step has been queued, so the host's next batch overlaps the card's
  step; batches cross from pinned memory (``device.to_device``).
* ``profile_dir`` traces steps ``profile_steps`` with ``torch.profiler``
  (``{profile_dir}/trace.json``, a Chrome trace).
* Under ``mesh`` the host-side agreements (the SIGTERM poll, the
  checkpoint barriers) run on a gloo group beside NCCL and never wait for
  the card; every window is polled (JAX: every ``preempt_poll_windows``-th).
* ``ENCODER_LOSS.VGG``'s frozen VGG-19 (``models/vgg.make_vgg``) reads
  ``VGG_WEIGHTS_PATH`` (``convert-vgg-weights``' ``.npz``, or a
  torchvision ``vgg19`` ``.pth``) as the JAX trainer does; without it, a
  seeded random init from a ``torch.Generator`` (not the JAX package's
  draw), which the log reports.
* SENT (SBERT) configs pool token embeddings from a seeded table with
  ``synthetic`` (a ``torch.Generator`` draw, not the JAX package's) and from
  the dataset's ``sbert_cache_{mode}.npz`` otherwise (``make_encode_fn``).
"""

from __future__ import annotations

import functools
import hashlib
import os
import signal
import warnings
from typing import Callable

import numpy as np
import torch

from xmc_gan_tpu_torch.config import Config
from xmc_gan_tpu_torch.data.pipeline import (
    DataLoader,
    SyntheticDataset,
    decode_route,
    index_to_sent,
)
from xmc_gan_tpu_torch.data.text_encode import SbertCache
from xmc_gan_tpu_torch.device import resolve_device, to_device
from xmc_gan_tpu_torch.models.concept_gan import set_mesh
from xmc_gan_tpu_torch.models.vgg import make_vgg
from xmc_gan_tpu_torch.parallel import any_rank, barrier, replicate
from xmc_gan_tpu_torch.registry import get_dataset, get_text_encoder
from xmc_gan_tpu_torch.train import create_train_state, make_sample_fn, make_train_step
from xmc_gan_tpu_torch.utils.checkpoint import CheckpointManager
from xmc_gan_tpu_torch.utils.convert import load_state_dict
from xmc_gan_tpu_torch.utils.logger import MetricWriter, Throughput, setup_logger
from xmc_gan_tpu_torch.utils.miscc import count_params, save_image_grid

__all__ = ["Trainer", "make_encode_fn", "make_sbert_table_encode", "sbert_table", "run_dir"]


def make_encode_fn(cfg: Config, *, device: str | torch.device | None = None,
                   weights: str | None = None, synthetic: bool = False,
                   data_dir: str | None = None) -> Callable:
    """Frozen text-encoder forward: ``batch -> (words, sent, mask)``, on
    ``device`` (default ``cuda``; see ``device.resolve_device``).

    ``TEXT.ENCODER_NAME: RNN``: ``batch`` holds ``caps`` ``[B, T]`` token ids
    and ``cap_lens`` ``[B]`` (numpy arrays or tensors).  The weights come from
    ``weights``, else from ``TEXT.ENCODER_DIR`` when that file exists
    (reference ``train_gan.py:461-468``: a reference ``RNN_ENCODER``
    ``state_dict`` loads directly); otherwise the encoder is randomly
    initialized from seed 0 (a ``torch.Generator``, so not the JAX package's
    random weights).

    ``SBERT`` (``xmc_gan_tpu/trainer.py:74-105``): ``SBERTEncoder`` pools
    token embeddings.  With ``synthetic`` they are rows ``caps`` of a seeded
    ``[VOCA_SIZE, EMBEDDING_DIM]`` table (``sbert_table``) on the device, 0
    ids padding; otherwise they come from the ``SbertCache`` of
    ``data_dir`` for ``batch["mode"]`` (one cache a split), rows
    ``batch["cap_idx"]``, crossing to the card in fp16 from pinned memory.
    """
    dev = resolve_device(device)
    enc_cls = get_text_encoder(cfg.TEXT.ENCODER_NAME)
    if cfg.TEXT.ENCODER_NAME == "SBERT":
        if synthetic:
            return make_sbert_table_encode(cfg, sbert_table(cfg), dev)
        return _make_sbert_cache_encode(cfg, data_dir, dev)
    enc = enc_cls(cfg, gen=torch.Generator().manual_seed(0))
    path = weights or cfg.TEXT.ENCODER_DIR
    if weights and not os.path.isfile(weights):
        raise FileNotFoundError(weights)
    if path and os.path.isfile(path):
        enc.load_state_dict(load_state_dict(path))
    elif path:
        warnings.warn(f"text encoder weights {path!r} not found; using random weights "
                      "(seed 0)", stacklevel=2)
    enc = enc.to(dev).eval().requires_grad_(False)

    # no_grad, not inference_mode: the train step saves these tensors for
    # its backward, which inference tensors refuse
    @torch.no_grad()
    def encode(batch: dict) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        caps = to_device(np.asarray(batch["caps"], np.int64), dev)
        lens = torch.as_tensor(np.asarray(batch["cap_lens"]), dtype=torch.int64)
        return enc(caps, lens)

    return encode


SBERT_TABLE_SEED = 42  # the JAX package's PRNGKey(42) table (xmc_gan_tpu/trainer.py:83)


def sbert_table(cfg: Config) -> torch.Tensor:
    """The synthetic captions' token-embedding table ``[VOCA_SIZE,
    EMBEDDING_DIM]`` of N(0, 1) draws from a CPU ``torch.Generator`` seeded
    with ``SBERT_TABLE_SEED`` (not the JAX package's ``jax.random`` draw)."""
    return _seeded_normal(cfg.TEXT.VOCA_SIZE, cfg.TEXT.EMBEDDING_DIM, SBERT_TABLE_SEED)


def make_sbert_table_encode(cfg: Config, table, device: torch.device) -> Callable:
    """SBERT pooling over rows ``batch["caps"]`` of ``table`` (numpy or
    tensor, ``[VOCA_SIZE, EMBEDDING_DIM]``, moved to ``device`` once); id 0
    is padding."""
    enc = get_text_encoder("SBERT")(cfg)
    table = to_device(table, device).float()

    @torch.no_grad()
    def encode(batch: dict) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        caps = to_device(np.asarray(batch["caps"], np.int64), device)
        return enc(table[caps], caps != 0)

    return encode


def _make_sbert_cache_encode(cfg: Config, data_dir: str | None, device: torch.device
                             ) -> Callable:
    if data_dir is None:
        raise ValueError("SENT encoding from disk needs data_dir (or synthetic=True)")
    enc = get_text_encoder("SBERT")(cfg)
    caches: dict[str, SbertCache] = {}

    @torch.no_grad()
    def encode(batch: dict) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        mode = batch.get("mode", "train")
        mode = mode[0] if isinstance(mode, (list, tuple)) else mode
        if mode not in caches:
            caches[mode] = SbertCache(data_dir, mode)
        tok, attn = caches[mode].rows(batch["cap_idx"])
        # fp16 rows (79 MB a batch at the LN shape), pinned and non_blocking
        # (to_device); SBERTEncoder casts them to fp32 on the device
        return enc(to_device(tok, device), to_device(attn, device))

    return encode


def run_dir(cfg: Config, output_root: str, seed: int) -> str:
    """A run's output directory (reference ``train_gan.py:416-425``)."""
    return f"{output_root}/{cfg.DATASET_NAME}{cfg.IMG.SIZE}_{cfg.CONFIG_NAME}_{seed}"


def _seeded_normal(n: int, dim: int, seed: int) -> torch.Tensor:
    """``[n, dim]`` draws of N(0, 1) from a CPU ``torch.Generator`` seeded with ``seed``."""
    return torch.randn(n, dim, generator=torch.Generator().manual_seed(seed))


def _mixed_seed(*parts: int) -> int:
    """One 64-bit seed from several integers."""
    digest = hashlib.blake2b(":".join(map(str, parts)).encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little")


class Trainer:
    """The end-to-end training loop.  ``synthetic=True`` runs fully data-free."""

    def __init__(
        self,
        cfg: Config,
        *,
        seed: int = 100,
        data_dir: str | None = None,
        output_root: str = "output",
        log_type: str = "tb",
        synthetic: bool = False,
        synthetic_len: int = 512,
        mesh=None,
        save_after: int = 50,
        num_threads: int | None = None,
        eval_num_samples: int = 6000,
        eval_fid: bool = True,
        dtype: torch.dtype | None = None,
        device: str | torch.device | None = None,
        profile_dir: str | None = None,
        profile_steps: tuple[int, int] = (10, 20),
        save_every_steps: int | None = None,
        steps_per_dispatch: int = 1,
        ckpt_on_preempt: bool = True,
        watch: bool = False,
        spectral_iters: int = 1,
    ):
        # a data-parallel rank runs on its mesh's device
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.mesh = mesh
        self.rank, self.world = (mesh.rank, mesh.world) if mesh is not None else (0, 1)
        self.cfg = cfg
        self.seed = seed
        self.save_after = save_after
        self.eval_num_samples = eval_num_samples
        self.eval_fid = eval_fid
        self.profile_dir = profile_dir
        self.profile_steps = profile_steps
        self._profiler = None

        out = run_dir(cfg, output_root, seed)
        self.output_dir = out
        self.img_dir = f"{out}/img"
        self.log_dir = f"{out}/log"
        self.model_dir = f"{out}/model"
        if self.rank == 0:
            for d in (out, self.img_dir, self.log_dir, self.model_dir):
                os.makedirs(d, exist_ok=True)
        self.logger = setup_logger(cfg.CONFIG_NAME or "xmc_gan_tpu_torch", self.log_dir,
                                   self.rank)
        self.writer = MetricWriter(self.log_dir, log_type, self.rank)
        # wandb.watch parity (reference train_gan.py:163-164): per-layer
        # parameter histograms and the applied updates since the previous
        # watch point, once an epoch (--watch)
        self.watch = bool(watch)
        self._watch_prev = None

        # ---------------------------------------------------------- data
        if synthetic:
            self.train_set = SyntheticDataset(cfg, synthetic_len, "train")
            self.test_set = SyntheticDataset(cfg, max(synthetic_len // 4, 8), "test")
        else:
            if not data_dir:
                raise ValueError("data_dir is required unless synthetic=True")
            ds_cls = get_dataset(cfg.TEXT.TYPE)
            self.train_set = ds_cls(data_dir, "train", cfg)
            self.test_set = ds_cls(data_dir, "test", cfg)
        bs = cfg.TRAIN.BATCH_SIZE
        if num_threads is None:  # reference DataLoader(num_workers=...), train_gan.py:456-457
            num_threads = cfg.TRAIN.NUM_WORKERS
        shard = (self.rank, self.world)  # bs is the global batch; each rank loads its shard
        self.train_loader = DataLoader(self.train_set, bs, shuffle=True, drop_last=True,
                                       seed=seed, num_threads=num_threads, shard=shard)
        self.test_loader = DataLoader(self.test_set, bs, shuffle=False, drop_last=True,
                                      seed=seed, num_threads=num_threads, shard=shard)
        self.decode_route = decode_route(self.train_set)
        self.logger.info(f"Image decode: {self.decode_route}")

        # ------------------------------------------------- encoder + step
        # bf16 activations on the card by default (params and losses fp32);
        # fp32 on the CPU
        if dtype is None:
            dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32
        self.dtype = dtype
        self.encode = make_encode_fn(cfg, device=self.device, synthetic=synthetic,
                                     data_dir=data_dir)
        self.state = create_train_state(cfg, dtype, self.device, seed=seed)
        if cfg.DISC.ENCODER_DIR and os.path.isfile(cfg.DISC.ENCODER_DIR):
            self._warm_start_d(cfg.DISC.ENCODER_DIR)
        self._replicate()
        self.logger.info(f"netG # of parameters: {count_params(self.state.g)}")
        self.logger.info(f"netD # of parameters: {count_params(self.state.d)}")
        # spectral_iters=1 is the JAX package's default cadence; 5 is the
        # reference's per-forward count
        step_fn = make_train_step(cfg, spectral_iters=spectral_iters, mesh=mesh)
        # the frozen VGG-19 of ENCODER_LOSS.VGG (VGG_WEIGHTS_PATH, .npz or
        # .pth; a seeded random init without it), bound into every step
        self.vgg = (make_vgg(dtype, self.device, log=self.logger.info)
                    if cfg.TRAIN.ENCODER_LOSS.VGG else None)
        self.step_fn = step_fn if self.vgg is None else functools.partial(step_fn, vgg=self.vgg)
        self.steps_per_dispatch = max(1, int(steps_per_dispatch))
        self._multi_step_calls = 0  # full windows of K > 1 steps run

        self.ckpt = CheckpointManager(self.model_dir)
        self.save_every_steps = save_every_steps
        self.auto_ckpt = (CheckpointManager(f"{self.model_dir}/auto", max_to_keep=2)
                          if save_every_steps else None)
        self.state_epoch = 0
        self.global_step = 0
        self._resume_skip = 0  # mid-epoch batches to skip on the first fit epoch
        # a SIGTERM during fit() saves an exact auto-checkpoint at the next
        # window boundary and returns; with the exact resume a preempted run
        # loses nothing
        self.ckpt_on_preempt = ckpt_on_preempt and self.auto_ckpt is not None
        self._preempted = False
        self._fixed = None
        self._fid = None

    def _warm_start_d(self, path: str) -> None:
        """D from a reference ``NetD`` checkpoint, ``strict=False`` semantics
        (reference ``train_gan.py:494-495``): tensors present in D with the
        same shape load (torch ``spectral_norm``'s ``weight_orig`` as
        ``weight``), the rest keep their initial values; ``resume`` overrides."""
        own = self.state.d.state_dict()
        upd, skipped = {}, []
        for name, value in load_state_dict(path).items():
            if name.endswith(".weight_orig"):
                name = name[: -len("_orig")]
            if name in own and own[name].shape == value.shape:
                upd[name] = value
            else:
                skipped.append(name)
        self.state.d.load_state_dict(upd, strict=False)
        self.logger.info(f"Warm-started D from {path}"
                         + (f" (skipped {len(skipped)} tensors)" if skipped else ""))

    def _replicate(self) -> None:
        """Rank 0's state on every rank, and G's BatchNorm over the global batch."""
        if self.mesh is not None:
            replicate(self.mesh, self.state)
            set_mesh(self.state.g, self.mesh)

    def _save(self, manager: CheckpointManager, index: int) -> None:
        """Rank 0 writes the checkpoint; every rank leaves once it is on disk."""
        if self.rank == 0:
            manager.save(index, self.state)
        if self.mesh is not None:
            barrier(self.mesh)

    def _rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global draw."""
        return x if self.mesh is None else x[self.mesh.rows(x.shape[0] // self.world)]

    # ------------------------------------------------------------------ #

    def resume(self, epoch: int | None = None) -> int:
        """Restore state from a checkpoint (reference ``--resume_epoch``,
        ``train_gan.py:486-493``; the optimizer state is the epoch's own)."""
        self.state, self.state_epoch = self.ckpt.restore(self.state, epoch)
        self._replicate()
        self.global_step = self.state.step
        self.logger.info(f"Load models, epoch : {self.state_epoch}")
        return self.state_epoch

    def resume_latest_auto(self) -> int:
        """Restore the newest step-indexed auto-checkpoint (crash recovery).

        Resume is exact: ``fit`` repositions the loader to the batch that
        the restored step count implies (the per-epoch order is a seeded
        permutation), and ``step_noise`` is a pure function of the global
        step, so the continued run is the run that would have happened
        without the crash.  With no auto-checkpoint yet it starts fresh."""
        if self.auto_ckpt is None:
            raise ValueError("resume_latest_auto needs save_every_steps")
        if self.auto_ckpt.latest_epoch() is None:
            self.logger.info("No auto checkpoint yet; starting fresh")
            return 0
        self.state, step = self.auto_ckpt.restore(self.state)
        self._replicate()
        self.global_step = self.state.step
        spe = max(len(self.train_loader), 1)
        self.state_epoch = self.global_step // spe
        self._resume_skip = self.global_step - self.state_epoch * spe
        self.logger.info(f"Load auto checkpoint, step : {step}"
                         + (f" (mid-epoch: skipping {self._resume_skip} consumed batches)"
                            if self._resume_skip else ""))
        return step

    def step_noise(self, global_step: int) -> torch.Tensor:
        """G's noise for the step that brings the counter to ``global_step``:
        ``[BATCH_SIZE, NOISE_DIM]`` from a CPU ``torch.Generator`` seeded from
        ``(seed, global_step)``, on the state's device; under ``mesh`` this
        rank's rows of that global draw."""
        noise = _seeded_normal(self.cfg.TRAIN.BATCH_SIZE, self.cfg.TRAIN.NOISE_DIM,
                               _mixed_seed(self.seed + 7, global_step))
        return to_device(self._rows(noise), self.device)

    def _prep_batch(self, batch: dict) -> dict:
        words, sent, mask = self.encode(batch)
        return {"imgs": to_device(batch["imgs"], self.device), "sent_embs": sent,
                "words_embs": words, "mask": mask}

    def _sample(self, noise, sent, words, mask) -> np.ndarray:
        fake = make_sample_fn(self.cfg, self.state.g)(noise, sent, words, mask)
        return fake.float().cpu().numpy()

    def _setup_fixed_batch(self) -> None:
        """Fixed noise and text for the per-epoch sample grid (reference
        ``train_gan.py:146-160``), from the first batch (``first_batch``: no
        read-ahead; under ``mesh`` this rank's shard, whose grid rank 0
        saves)."""
        batch = self.train_loader.first_batch()
        words, sent, mask = self.encode(batch)
        noise = self._rows(_seeded_normal(sent.shape[0] * self.world, self.cfg.TRAIN.NOISE_DIM,
                                          self.seed + 1))
        self._fixed = (noise, sent, words, mask)
        if self.rank != 0:
            return
        if self.cfg.TEXT.TYPE == "WORD" and hasattr(self.train_set, "i2w"):
            sents = index_to_sent(self.train_set.i2w, batch["caps"])
        else:
            sents = [str(c) for c in batch["caps"]]
        with open(f"{self.img_dir}/sents.txt", "w") as f:
            for s in sents:
                f.write(f"{s} \n")
        save_image_grid(np.asarray(batch["imgs"]), f"{self.img_dir}/imgs.png")

    def _save_step_grid(self, batch: dict, step: int) -> None:
        """The in-epoch grid from the current batch's text (reference
        ``fake_samples_{step:03d}.png``, ``train_gan.py:297-298``).  Every
        rank samples (G's BatchNorm may be a collective); rank 0 saves its
        slice, as the JAX trainer does (``xmc_gan_tpu/trainer.py:490-520``)."""
        noise = self._rows(_seeded_normal(batch["sent_embs"].shape[0] * self.world,
                                          self.cfg.TRAIN.NOISE_DIM, self.seed + step))
        fake = self._sample(noise, batch["sent_embs"], batch["words_embs"], batch["mask"])
        if self.rank == 0:
            save_image_grid(fake, f"{self.img_dir}/fake_samples_{step:03d}.png")

    def sample_fixed_grid(self, epoch: int) -> None:
        if self._fixed is None:
            self._setup_fixed_batch()
        fake = self._sample(*self._fixed)  # on every rank, as _save_step_grid
        if self.rank == 0:
            save_image_grid(fake, f"{self.img_dir}/fake_samples_epoch_{epoch:03d}.png")

    def evaluate(self, epoch: int) -> float:
        """Post-checkpoint FID (reference ``train_gan.py:334,338-396``):
        ``eval_num_samples`` samples with fresh noise against the test
        images, through Inception pool3; under ``mesh`` every rank scores
        its test shard and the statistics are all-reduced."""
        from xmc_gan_tpu_torch.eval import FidComputer, evaluate_fid

        if self._fid is None:
            self._fid = FidComputer(device=self.device)
            if not self._fid.pretrained:
                self.logger.info(
                    "FID: no Inception weights found (FID_WEIGHTS_PATH unset) — using a fixed "
                    "random-init extractor; values track relative progress only.")
        fid_value = evaluate_fid(self.cfg, self.state.g, self.encode, self.test_loader,
                                 num_samples=self.eval_num_samples, seed=self.seed + epoch,
                                 fid=self._fid, mesh=self.mesh)
        self.logger.info(f"epoch : {epoch}, {self.fid_scalar_name} : {fid_value:.3f}")
        return fid_value

    @property
    def fid_scalar_name(self) -> str:
        """``FID`` only when real Inception weights back the number; the
        random-init extractor's value is a relative-progress proxy."""
        if self._fid is not None and not self._fid.pretrained:
            return "FID_randinit_proxy"
        return "FID"

    def _log_watch(self, epoch: int) -> None:
        """``wandb.watch`` telemetry: ``parameters/net{G,D}/...`` histograms
        plus ``updates/net{G,D}/...``, the applied optimizer deltas since the
        previous watch point.  One device->host copy an epoch, on rank 0 (the
        ranks hold the same parameters)."""
        if self.rank != 0:
            return
        params = {f"{prefix}/{name.replace('.', '/')}": np.array(p.detach().float().cpu())
                  for prefix, net in (("netG", self.state.g), ("netD", self.state.d))
                  for name, p in net.named_parameters()}
        hists = {f"parameters/{k}": v for k, v in params.items()}
        if self._watch_prev is not None:
            hists.update({f"updates/{k}": v - self._watch_prev[k] for k, v in params.items()})
        self._watch_prev = params
        self.writer.histograms(epoch, hists)

    def _profile(self) -> None:
        """Start the trace at step ``profile_steps[0]``, stop and write it at
        ``profile_steps[1]`` (or when ``fit`` ends first)."""
        if not self.profile_dir:
            return
        if self._profiler is None and self.global_step == self.profile_steps[0]:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
                # the trace then holds the traced steps' kernels and no earlier one's
                torch.cuda.synchronize(self.device)
            self._profiler = torch.profiler.profile(activities=acts)
            self._profiler.start()
        elif self._profiler is not None and self.global_step >= self.profile_steps[1]:
            self._stop_profiler()

    def _stop_profiler(self) -> None:
        if self._profiler is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._profiler.stop()
        os.makedirs(self.profile_dir, exist_ok=True)
        path = os.path.join(self.profile_dir, "trace.json")
        self._profiler.export_chrome_trace(path)
        self._profiler = None
        self.logger.info(f"Profiler trace written to {path}")

    # ------------------------------------------------------------------ #

    def fit(self, max_epochs: int | None = None, max_steps: int | None = None,
            eval_fn: Callable | None = None) -> dict:
        """Run the training loop; returns the last metric dict (host floats)."""
        cfg = self.cfg
        n_critic = cfg.TRAIN.N_CRITIC
        max_epochs = max_epochs or cfg.TRAIN.MAX_EPOCH
        if self._fixed is None:
            self._setup_fixed_batch()
        meter = Throughput(cfg.TRAIN.BATCH_SIZE)
        last_metrics: dict = {}
        steps_done = 0
        # (metas, per-step metric dicts) of the last window whose metrics are
        # still on the card; read after the next window is queued.  A meta is
        # (epoch, step in epoch, steps per epoch, global step).
        pending: tuple | None = None

        def flush_pending() -> None:
            nonlocal pending, last_metrics
            if pending is None:
                return
            metas, ms = pending
            pending = None
            keys = list(ms[0])
            rows = torch.stack([torch.stack([m[k].float() for k in keys]) for m in ms])
            for (p_epoch, p_step, p_spe, gstep), row in zip(metas, rows.cpu().tolist()):
                # the persisted counter the step gates G's update on
                # (train.py), not the per-epoch index: they differ when
                # steps_per_epoch % N_CRITIC != 0
                if gstep % n_critic != 0:
                    continue
                last_metrics = dict(zip(keys, row))
                self.logger.info(
                    f"[{p_epoch}/{max_epochs}][{p_step}/{p_spe}] "
                    f"Loss_D: {last_metrics['Loss_D']:.3f} "
                    f"Loss_G: {last_metrics['Loss_G']:.3f} "
                    f"errD_real: {last_metrics['errD_real']:.3f} "
                    f"errD_fake: {last_metrics['errD_fake']:.3f} ")

        K = self.steps_per_dispatch
        win: list = []  # staged (batch, noise, meta)

        # preemption: the handler only sets a flag; the loop acts on it at
        # the next window boundary, where the state is at an exact step.
        # Sentinel, not None: signal.signal() returns None for a handler
        # installed outside Python, which still needs restoring.
        no_handler = object()
        prev_handler = no_handler
        self._preempted = False  # a prior preempted fit() must not poison this one
        if self.ckpt_on_preempt:
            try:
                prev_handler = signal.signal(signal.SIGTERM,
                                             lambda *_: setattr(self, "_preempted", True))
            except ValueError:  # not the main thread: no handler
                prev_handler = no_handler
        preempt_handled = False

        def preempt_save() -> bool:
            nonlocal preempt_handled
            if not self.ckpt_on_preempt:
                return False
            if preempt_handled:
                return True
            # under mesh a collective at a boundary every rank reaches: a
            # SIGTERM on any rank stops all of them at the same step
            flag = self._preempted
            if not (flag if self.mesh is None else any_rank(self.mesh, flag)):
                return False
            flush_pending()
            step_now = self.state.step
            if self.auto_ckpt.latest_epoch() != step_now:
                self._save(self.auto_ckpt, step_now)
                self.logger.info(f"Preempted: auto checkpoint saved at step {step_now}; exiting")
            else:
                self.logger.info(f"Preempted: step {step_now} already checkpointed; exiting")
            preempt_handled = True
            return True

        def run_window() -> None:
            # window boundaries are a pure function of the step index
            # (len == K, epoch end, max_steps)
            nonlocal win, pending
            if not win:
                return
            staged, win = win, []
            ms = [self.step_fn(self.state, batch, noise) for batch, noise, _ in staged]
            metas = [meta for *_, meta in staged]
            if K > 1 and len(staged) == K:
                self._multi_step_calls += 1
            flush_pending()
            if any(g % n_critic == 0 for *_, g in metas):
                pending = (metas, ms)
            gs_first, gs_last = metas[0][3], metas[-1][3]
            if self.auto_ckpt and (gs_last // self.save_every_steps
                                   > (gs_first - 1) // self.save_every_steps):
                # labelled with the window's last step (the exact step when K == 1)
                self._save(self.auto_ckpt, gs_last)

        try:
            for epoch in range(self.state_epoch + 1, max_epochs + 1):
                # mid-epoch resume: reposition the loader to the batch the
                # restored step implies (first resumed epoch only)
                skip, self._resume_skip = self._resume_skip, 0
                self.train_loader.set_epoch(epoch, start_batch=skip)
                steps_per_epoch = len(self.train_loader)
                for step, raw in enumerate(self.train_loader, start=skip):
                    self._profile()
                    batch = self._prep_batch(raw)
                    meter.step()
                    self.global_step += 1
                    steps_done += 1
                    meta = (epoch, step + 1, steps_per_epoch, self.global_step)
                    hit_max = bool(max_steps and steps_done >= max_steps)
                    win.append((batch, self.step_noise(self.global_step), meta))
                    if len(win) == K or (step + 1) == steps_per_epoch or hit_max:
                        run_window()
                        if preempt_save():
                            break
                    if (step + 1) % cfg.TRAIN.LOG_INTERVAL == 0:
                        # under K > 1 the params may lag this step by < K
                        # staged steps: a progress picture, not a window flush
                        self._save_step_grid(batch, step + 1)
                    if hit_max:
                        break

                # drain the staged batches and the last window, so the
                # epoch's scalars and the return value see its last metrics
                run_window()
                flush_pending()
                if preempt_save():
                    break
                # per-epoch scalars: the last step's values (reference quirk,
                # train_gan.py:300-321) + throughput
                self.writer.scalars(epoch, {"epoch": epoch, **last_metrics, **meter.rates()})
                if self.watch:
                    self._log_watch(epoch)
                meter.reset()

                self.sample_fixed_grid(epoch)

                if epoch > self.save_after:
                    self._save(self.ckpt, epoch)
                    self.logger.info("Save models")
                    if eval_fn is not None:
                        eval_fn(self, epoch)
                    elif self.eval_fid:
                        fid_value = self.evaluate(epoch)
                        self.writer.scalars(epoch, {self.fid_scalar_name: fid_value})
                if max_steps and steps_done >= max_steps:
                    break
        finally:
            self._stop_profiler()
            if prev_handler is not no_handler:
                # restored on every exit, exceptions included: a leaked
                # flag-setter would make the process swallow SIGTERM.  A None
                # prior handler (set outside Python) cannot be reinstalled;
                # SIG_DFL is the closest.
                signal.signal(signal.SIGTERM,
                              signal.SIG_DFL if prev_handler is None else prev_handler)
        return last_metrics
