"""Command line of the port: ``train``, ``eval`` and ``sample``.

    python -m xmc_gan_tpu_torch.cli train --cfg xmc_gan_tpu/cfg/df_gan_damsm.yml \\
        --data_dir data/coco [--synthetic] [--max_epochs N] [--resume_auto] ...
    python -m xmc_gan_tpu_torch.cli eval --cfg ... [--resume_epoch E] [--protocol fid30k]
    python -m xmc_gan_tpu_torch.cli sample --cfg ... --data_dir data/coco \\
        --caption "a red bird on a branch" [--resume_epoch E | --weights G.pth]

Port of the JAX CLI's ``train``, ``eval`` and ``sample``
(``xmc_gan_tpu/cli.py:26-100,187-202,207-313,336-385``) with the flags that
mean something on one card, and ``--device`` (default ``cuda``; ``cpu`` only
when asked).  ``train`` writes the JAX package's layout under
``{output_root}/{DATASET_NAME}{SIZE}_{CONFIG_NAME}_{seed}/`` with the port's
own checkpoints (``utils/checkpoint.py``); ``eval`` and ``sample`` read them.
Data parallelism runs one process per card under torchrun, which sets the
group's environment (``parallel.make_mesh``):

    torchrun --nproc_per_node N -m xmc_gan_tpu_torch.cli train --cfg ... \
        --distributed [--dp N]

``TRAIN.BATCH_SIZE`` (``--bs``) is the global batch; NCCL on the cards, gloo
with ``--device cpu``.  ``eval --distributed`` scores each rank's test shard
and all-reduces the FID statistics.  ``--dp`` without ``--distributed``
raises (one process drives one card), and so does ``--tp`` > 1: tensor
parallelism is not ported.  SENT (SBERT) configs train and evaluate (their captions
from the dataset's ``sbert_cache_{mode}.npz``, or a seeded table with
``--synthetic``); ``sample`` raises for them: a new caption needs the
RoBERTa transformer and its ``stsb-roberta-base`` weights, which are not in
the repository.
The noise is drawn with ``torch.Generator``s, so the images differ from the
JAX CLI's (``jax.random``) for the same seed.
"""

from __future__ import annotations

import argparse
import dataclasses
import random
import sys
import warnings

import numpy as np
import torch

from xmc_gan_tpu_torch.config import Config, cfg_from_file
from xmc_gan_tpu_torch.data.vocab import load_w2i, tokenize
from xmc_gan_tpu_torch.device import DTYPES
from xmc_gan_tpu_torch.parallel import make_mesh, shutdown
from xmc_gan_tpu_torch.parallel.mesh import TP_REFUSAL
from xmc_gan_tpu_torch.train import make_generator, make_sample_fn
from xmc_gan_tpu_torch.trainer import Trainer, make_encode_fn, run_dir
from xmc_gan_tpu_torch.utils.checkpoint import CheckpointManager
from xmc_gan_tpu_torch.utils.miscc import save_image_grid

__all__ = ["main", "parse_args", "run_train", "run_eval", "run_sample"]


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="xmc_gan_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train", help="train a text-to-image GAN")
    t.add_argument("--cfg", required=True, help="YAML config (reference schema)")
    t.add_argument("--seed", type=int, default=100)
    t.add_argument("--resume_epoch", type=int, default=0)
    # "wdb" is the reference's spelling for wandb (train_gan.py:162,300)
    t.add_argument("--log_type", default="tb", choices=["tb", "wandb", "wdb", "none"])
    t.add_argument("--bs", type=int, default=-1, help="override TRAIN.BATCH_SIZE")
    t.add_argument("--imsize", type=int, default=-1, help="override IMG.SIZE")
    t.add_argument("--data_dir", default=None)
    t.add_argument("--output_root", default="output")
    t.add_argument("--synthetic", action="store_true",
                   help="data-free run on synthetic images/captions")
    t.add_argument("--synthetic_len", type=int, default=512)
    t.add_argument("--max_epochs", type=int, default=None)
    t.add_argument("--max_steps", type=int, default=None)
    t.add_argument("--save_after", type=int, default=50,
                   help="checkpoint every epoch once epoch > this (reference: 50)")
    t.add_argument("--no_eval_fid", action="store_true",
                   help="skip the post-checkpoint FID eval")
    t.add_argument("--eval_num_samples", type=int, default=6000)
    t.add_argument("--dtype", default=None, choices=sorted(DTYPES),
                   help="activation dtype (default: bf16 on cuda, fp32 on cpu)")
    t.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    t.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler trace of steps 10-20 here")
    t.add_argument("--save_every_steps", type=int, default=None,
                   help="step-indexed auto-checkpoints for crash recovery")
    t.add_argument("--watch", action="store_true",
                   help="per-layer parameter/update histograms each epoch "
                        "(wandb.watch parity, reference train_gan.py:163-164)")
    t.add_argument("--steps_per_dispatch", type=int, default=1,
                   help="window of K steps between auto-save and preemption checks")
    t.add_argument("--spectral_iters", type=int, default=1,
                   help="spectral-norm power-iteration refreshes per step (5 = the "
                        "reference's per-forward count)")
    t.add_argument("--resume_auto", action="store_true",
                   help="resume from the newest auto checkpoint")
    t.add_argument("--dp", type=int, default=None,
                   help="data-parallel ranks (default: the world size under --distributed)")
    t.add_argument("--tp", type=int, default=1, help="tensor parallelism (not ported: 1 only)")
    t.add_argument("--distributed", action="store_true",
                   help="one rank of a torchrun group (env://), one process per card")

    e = sub.add_parser("eval", help="FID eval of a checkpoint (reference eval(), "
                                    "train_gan.py:338-396)")
    e.add_argument("--cfg", required=True)
    e.add_argument("--seed", type=int, default=100)
    e.add_argument("--resume_epoch", type=int, default=0,
                   help="epoch to evaluate (default: latest checkpoint)")
    e.add_argument("--data_dir", default=None)
    e.add_argument("--output_root", default="output")
    e.add_argument("--synthetic", action="store_true")
    e.add_argument("--synthetic_len", type=int, default=512)
    e.add_argument("--num_samples", type=int, default=None,
                   help="default: 6000 (ref6k) / 30000 (fid30k)")
    e.add_argument("--protocol", default="ref6k", choices=["ref6k", "fid30k"],
                   help="ref6k = reference 6000-sample eval (train_gan.py:386-387); fid30k = "
                        "XMC-GAN paper FID-30K (30k samples vs full test statistics)")
    e.add_argument("--save_images", action="store_true",
                   help="also write per-key PNGs like the reference eval loop")
    e.add_argument("--bs", type=int, default=-1)
    e.add_argument("--imsize", type=int, default=-1)
    e.add_argument("--dtype", default=None, choices=sorted(DTYPES))
    e.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    e.add_argument("--distributed", action="store_true",
                   help="one rank of a torchrun group: each scores its test shard")

    s = sub.add_parser("sample", help="generate images from captions")
    s.add_argument("--cfg", required=True)
    s.add_argument("--data_dir", required=True,
                   help="dataset root (provides the vocabulary, captions.pickle)")
    s.add_argument("--caption", action="append", required=True,
                   help="caption text; repeat for a grid of captions")
    s.add_argument("--output_root", default="output",
                   help="where train wrote its run (G comes from its checkpoint)")
    s.add_argument("--resume_epoch", type=int, default=0,
                   help="checkpoint epoch (default: latest)")
    s.add_argument("--weights", default=None,
                   help="G state_dict (.pth, reference names) in place of a checkpoint")
    s.add_argument("--text_encoder", default=None,
                   help="DAMSM text encoder state_dict (default: TEXT.ENCODER_DIR)")
    s.add_argument("--dtype", choices=sorted(DTYPES), default="fp32")
    s.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    s.add_argument("--seed", type=int, default=100)
    s.add_argument("--n_per_caption", type=int, default=4)
    s.add_argument("--out", default="samples.png")
    return p.parse_args(argv)


def _cfg(args: argparse.Namespace) -> Config:
    cfg = cfg_from_file(args.cfg)
    if args.imsize != -1:
        cfg = cfg.replace(IMG=dataclasses.replace(cfg.IMG, SIZE=args.imsize))
    if args.bs != -1:
        cfg = cfg.replace(TRAIN=dataclasses.replace(cfg.TRAIN, BATCH_SIZE=args.bs))
    return cfg


def _dtype(args: argparse.Namespace):
    return None if args.dtype is None else DTYPES[args.dtype]


def _mesh(args: argparse.Namespace):
    """The data-parallel rank of ``--distributed`` (None without it)."""
    if getattr(args, "tp", 1) != 1:
        raise NotImplementedError(f"--tp {args.tp}: {TP_REFUSAL}")
    dp = getattr(args, "dp", None)
    if not args.distributed:
        if dp is not None:
            raise ValueError(f"--dp {dp} runs one process per card: launch it with torchrun "
                             f"--nproc_per_node {dp} and --distributed")
        return None
    return make_mesh(dp, device=args.device)


def run_train(args: argparse.Namespace) -> dict:
    mesh = _mesh(args)
    cfg = _cfg(args)
    random.seed(args.seed)
    np.random.seed(args.seed)
    trainer = Trainer(
        cfg, seed=args.seed, data_dir=args.data_dir, output_root=args.output_root,
        log_type=args.log_type, synthetic=args.synthetic, synthetic_len=args.synthetic_len,
        mesh=mesh, save_after=args.save_after, eval_fid=not args.no_eval_fid,
        eval_num_samples=args.eval_num_samples, dtype=_dtype(args), device=args.device,
        profile_dir=args.profile_dir, save_every_steps=args.save_every_steps,
        steps_per_dispatch=args.steps_per_dispatch, watch=args.watch,
        spectral_iters=args.spectral_iters,
    )
    trainer.logger.info("Using config:")
    trainer.logger.info(str(cfg.to_dict()))
    trainer.logger.info(f"seed now is : {args.seed}")
    if args.resume_auto:
        trainer.resume_latest_auto()
    elif args.resume_epoch:
        trainer.resume(args.resume_epoch)
    return trainer.fit(max_epochs=args.max_epochs, max_steps=args.max_steps)


def run_eval(args: argparse.Namespace) -> tuple[str, float]:
    """Returns (scalar name, value): the name tells a real FID from the
    random-init extractor's proxy."""
    from xmc_gan_tpu_torch.eval import FidComputer, evaluate_fid, evaluate_fid_30k

    mesh = _mesh(args)
    cfg = _cfg(args)
    num_samples = args.num_samples or (30000 if args.protocol == "fid30k" else 6000)
    trainer = Trainer(cfg, seed=args.seed, data_dir=args.data_dir,
                      output_root=args.output_root, log_type="none",
                      synthetic=args.synthetic, synthetic_len=args.synthetic_len, mesh=mesh,
                      eval_num_samples=num_samples, dtype=_dtype(args), device=args.device)
    trainer.resume(args.resume_epoch or None)
    fid = FidComputer(device=trainer.device)
    name = "FID" if fid.pretrained else "FID_randinit_proxy"
    g, encode, loader = trainer.state.g, trainer.encode, trainer.test_loader
    if args.protocol == "fid30k":
        value = evaluate_fid_30k(cfg, g, encode, loader, num_samples=num_samples,
                                 seed=args.seed, fid=fid, mesh=mesh)
        trainer.logger.info(f"epoch : {trainer.state_epoch}, {name}-30K : {value:.3f}")
        return name, value
    save_dir = org_dir = None
    if args.save_images:
        save_dir = f"{trainer.img_dir}/eval_{trainer.state_epoch:03d}/fake"
        org_dir = f"{trainer.img_dir}/eval_{trainer.state_epoch:03d}/org"
    value = evaluate_fid(cfg, g, encode, loader, num_samples=num_samples, seed=args.seed,
                         save_dir=save_dir, org_dir=org_dir, fid=fid, mesh=mesh)
    trainer.logger.info(f"epoch : {trainer.state_epoch}, {name} : {value:.3f}")
    return name, value


def _g_weights(cfg: Config, args: argparse.Namespace) -> dict | None:
    """G's ``state_dict`` from the run's checkpoint (``--resume_epoch`` or the
    latest), or None where the run has none and no epoch was asked for."""
    ckpt = CheckpointManager(f"{run_dir(cfg, args.output_root, args.seed)}/model")
    epoch = args.resume_epoch or ckpt.latest_epoch()
    if epoch is None:
        return None
    return torch.load(ckpt.path(epoch), map_location="cpu", weights_only=True)["g"]


def run_sample(args: argparse.Namespace) -> str:
    cfg = cfg_from_file(args.cfg)
    if cfg.TEXT.TYPE != "WORD":
        raise NotImplementedError(
            "sample for SENT (SBERT) configs encodes new captions with the RoBERTa transformer "
            "(sentence-transformers/stsb-roberta-base) and its weights, which are not in the "
            "repository; it waits until they are")
    caps, cap_lens = tokenize(list(args.caption), load_w2i(args.data_dir),
                              cfg.TEXT.MAX_LENGTH)
    encode = make_encode_fn(cfg, device=args.device, weights=args.text_encoder)
    words, sent, mask = encode({"caps": caps, "cap_lens": cap_lens})
    n = args.n_per_caption
    words, sent, mask = (t.repeat_interleave(n, dim=0) for t in (words, sent, mask))
    g = make_generator(cfg, DTYPES[args.dtype], args.device, weights=args.weights,
                       seed=args.seed)
    if not args.weights:
        sd = _g_weights(cfg, args)
        if sd is None:
            warnings.warn(f"no checkpoint under {args.output_root} and no --weights: sampling "
                          f"from a random G (seed {args.seed})", stacklevel=2)
        else:
            g.load_state_dict(sd, strict=True)
    noise = torch.randn(sent.shape[0], cfg.TRAIN.NOISE_DIM,
                        generator=torch.Generator().manual_seed(args.seed))
    fake = make_sample_fn(cfg, g)(noise, sent, words, mask)
    save_image_grid(fake.float().cpu().numpy(), args.out, nrow=n)
    return args.out


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        if args.cmd == "train":
            out = {k: round(v, 4) for k, v in run_train(args).items()}
        elif args.cmd == "eval":
            name, value = run_eval(args)
            out = {name: round(value, 4)}
        else:
            out = run_sample(args)
        if not getattr(args, "distributed", False) or torch.distributed.get_rank() == 0:
            print(out)
    finally:
        if getattr(args, "distributed", False):
            shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
