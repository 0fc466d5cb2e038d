"""Command line of the port: ``sample`` (text -> image grid).

    python -m xmc_gan_tpu_torch.cli sample --cfg xmc_gan_tpu/cfg/df_gan_damsm.yml \\
        --data_dir data/coco --caption "a red bird on a branch" \\
        [--weights G.pth] [--text_encoder enc.pth] [--dtype fp32|bf16] [--device cuda|cpu]

Port of the JAX CLI's ``sample`` (``xmc_gan_tpu/cli.py:187-202,336-385``) for
WORD configs.  G weights come from a reference-named ``state_dict`` file
(``--weights``; reading the JAX package's Orbax checkpoints comes with the
trainer slice); without one G is random, drawn from ``--seed``.  The noise is
drawn with a ``torch.Generator`` seeded by ``--seed``, so the images differ
from the JAX CLI's (``jax.random``) for the same seed.
"""

from __future__ import annotations

import argparse
import sys
import warnings

import torch

from xmc_gan_tpu_torch.config import cfg_from_file
from xmc_gan_tpu_torch.data.vocab import load_w2i, tokenize
from xmc_gan_tpu_torch.device import DTYPES
from xmc_gan_tpu_torch.train import make_generator, make_sample_fn
from xmc_gan_tpu_torch.trainer import make_encode_fn
from xmc_gan_tpu_torch.utils.miscc import save_image_grid

__all__ = ["main", "parse_args", "run_sample"]


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="xmc_gan_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("sample", help="generate images from captions")
    s.add_argument("--cfg", required=True)
    s.add_argument("--data_dir", required=True,
                   help="dataset root (provides the vocabulary, captions.pickle)")
    s.add_argument("--caption", action="append", required=True,
                   help="caption text; repeat for a grid of captions")
    s.add_argument("--weights", default=None,
                   help="G state_dict (.pth, reference names); default: random G")
    s.add_argument("--text_encoder", default=None,
                   help="DAMSM text encoder state_dict (default: TEXT.ENCODER_DIR)")
    s.add_argument("--dtype", choices=sorted(DTYPES), default="fp32")
    s.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    s.add_argument("--seed", type=int, default=100)
    s.add_argument("--n_per_caption", type=int, default=4)
    s.add_argument("--out", default="samples.png")
    return p.parse_args(argv)


def run_sample(args: argparse.Namespace) -> str:
    cfg = cfg_from_file(args.cfg)
    if cfg.TEXT.TYPE != "WORD":
        raise NotImplementedError("SENT (SBERT) configs come with the SBERT slice of the port")
    caps, cap_lens = tokenize(list(args.caption), load_w2i(args.data_dir),
                              cfg.TEXT.MAX_LENGTH)
    encode = make_encode_fn(cfg, device=args.device, weights=args.text_encoder)
    words, sent, mask = encode({"caps": caps, "cap_lens": cap_lens})
    n = args.n_per_caption
    words, sent, mask = (t.repeat_interleave(n, dim=0) for t in (words, sent, mask))
    if not args.weights:
        warnings.warn(f"no --weights: sampling from a random G (seed {args.seed})", stacklevel=2)
    g = make_generator(cfg, DTYPES[args.dtype], args.device, weights=args.weights,
                       seed=args.seed)
    noise = torch.randn(sent.shape[0], cfg.TRAIN.NOISE_DIM,
                        generator=torch.Generator().manual_seed(args.seed))
    fake = make_sample_fn(cfg, g)(noise, sent, words, mask)
    save_image_grid(fake.cpu().numpy(), args.out, nrow=n)
    return args.out


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.cmd == "sample":
        print(run_sample(args))
    return 0


if __name__ == "__main__":
    sys.exit(main())
