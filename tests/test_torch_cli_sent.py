"""The port's command line for new SENT captions and ``train``'s reference
flags, on the CPU.

* ``sample`` on a SENT config (``df_gan_sbert.yml`` at tiny width, hidden
  32 = the tiny RoBERTa's, T = 16) encodes its captions with the port's
  RoBERTa from ``stsb-roberta-base``'s snapshot in a temporary HF hub cache
  (``HF_HUB_CACHE``), pools them with ``SBERTEncoder`` and writes the grid
  that the JAX encode function's embeddings give through the same G and
  noise (within one 8-bit level);
* ``prep-ln --build_cache --cfg`` writes the layout and both caches, equal
  to the JAX package's ``build_sbert_cache`` on the same captions (masks
  equal, fp16 within one ulp);
* both raise JAX's error where the hub cache has no weights, and
  ``--build_cache`` without ``--cfg`` exits;
* ``train --gpu``/``--gpu_id`` parse, pick ``cuda:N``, are ignored with
  ``--device cpu`` and raise under ``--distributed`` for N other than 0;
* ``train --debug_nans`` raises ``FloatingPointError`` at the step that
  made a NaN (anomaly mode's backward check, or the step's metrics) and is
  quiet without one.
"""

import ast
import json
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from torch_port_helpers import one_torch_thread  # noqa: F401  (fixture)
from torch_sbert_helpers import HIDDEN, MAX_LEN, hub_layout, write_tiny_roberta

from xmc_gan_tpu.config import cfg_from_file as jax_cfg_from_file
from xmc_gan_tpu.data import text_encode as jax_te
from xmc_gan_tpu_torch import cli
from xmc_gan_tpu_torch.config import cfg_from_file
from xmc_gan_tpu_torch.device import DTYPES
from xmc_gan_tpu_torch.models.encoder import SBERTEncoder
from xmc_gan_tpu_torch.train import make_generator, make_sample_fn
from xmc_gan_tpu_torch.trainer import Trainer
from xmc_gan_tpu_torch.utils.miscc import save_image_grid

pytestmark = pytest.mark.usefixtures("one_torch_thread")
CFG_DIR = Path(__file__).resolve().parents[1] / "xmc_gan_tpu" / "cfg"
CAPTIONS = ["a red bird sitting on the branch of a tree", "two dogs 🐕 in the snow, 3 balls"]
JAX_ERROR = r"Could not load 'sentence-transformers/stsb-roberta-base' weights locally"


def _tiny_yaml(tmp_path: Path, name: str) -> str:
    """The shipped YAML at tiny width, its text width the tiny RoBERTa's."""
    with open(CFG_DIR / name) as f:
        doc = yaml.safe_load(f)
    doc["TRAIN"].update({"NCH": 4, "NEF": 16, "NOISE_DIM": 8, "NUM_WORKERS": 2,
                         "LOG_INTERVAL": 1, "BATCH_SIZE": 4})
    doc["TEXT"].update({"EMBEDDING_DIM": HIDDEN, "MAX_LENGTH": MAX_LEN, "VOCA_SIZE": 40})
    path = tmp_path / name
    path.write_text(yaml.safe_dump(doc))
    return str(path)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return write_tiny_roberta(tmp_path_factory.mktemp("tiny_roberta"))


@pytest.fixture()
def hub(ckpt, tmp_path, monkeypatch):
    """``HF_HUB_CACHE`` holding ``stsb-roberta-base``'s snapshot: the tiny
    checkpoint."""
    hub = tmp_path / "hub"
    hub_layout(hub, ckpt)
    monkeypatch.setenv("HF_HUB_CACHE", str(hub))
    return hub


@pytest.fixture()
def empty_hub(tmp_path, monkeypatch):
    hub = tmp_path / "empty_hub"
    hub.mkdir()
    monkeypatch.setenv("HF_HUB_CACHE", str(hub))
    return hub


def test_cli_sample_encodes_sent_captions(hub, ckpt, tmp_path, capsys):
    cfg_path = _tiny_yaml(tmp_path, "df_gan_sbert.yml")
    out = tmp_path / "s.png"
    n = 2
    assert cli.main(["sample", "--cfg", cfg_path, "--data_dir", str(tmp_path), "--device", "cpu",
                     "--n_per_caption", str(n), "--out", str(out), "--output_root",
                     str(tmp_path / "none"), *sum([["--caption", c] for c in CAPTIONS], [])]) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1] == str(out)

    # the same request from the JAX package's encode function
    tok, attn = jax_te.make_hf_sbert_encode(jax_cfg_from_file(cfg_path), model_path=ckpt)(CAPTIONS)
    cfg = cfg_from_file(cfg_path)
    words, sent, mask = SBERTEncoder(cfg)(torch.from_numpy(np.asarray(tok)),
                                          torch.from_numpy(np.asarray(attn)))
    words, sent, mask = (t.repeat_interleave(n, dim=0) for t in (words, sent, mask))
    g = make_generator(cfg, DTYPES["fp32"], "cpu", seed=100)
    noise = torch.randn(sent.shape[0], cfg.TRAIN.NOISE_DIM,
                        generator=torch.Generator().manual_seed(100))
    want = tmp_path / "want.png"
    save_image_grid(make_sample_fn(cfg, g)(noise, sent, words, mask).numpy(), str(want), nrow=n)
    a = np.asarray(Image.open(out), np.int16)
    b = np.asarray(Image.open(want), np.int16)
    assert a.shape == b.shape and np.abs(a - b).max() <= 1


def _ln_jsonl(path: Path, rows) -> str:
    path.write_text("".join(json.dumps({"image_id": i, "caption": c}) + "\n" for i, c in rows))
    return str(path)


def test_cli_prep_ln_build_cache_matches_jax(hub, ckpt, tmp_path, capsys):
    train = _ln_jsonl(tmp_path / "t.jsonl", [("1", "In this image we can see a bird."),
                                             ("2", "A café, 2 dogs and it's  snowing"),
                                             ("3", "a <mask> " + "and a tree " * 8)])
    test = _ln_jsonl(tmp_path / "v.jsonl", [("4", "There is a red stove.")])
    cfg_path = _tiny_yaml(tmp_path, "ln_coco_256.yml")
    data = tmp_path / "ln"
    assert cli.main(["prep-ln", "--data_dir", str(data), "--train_jsonl", train, "--test_jsonl",
                     test, "--build_cache", "--cfg", cfg_path, "--device", "cpu"]) == 0
    assert "{'train': 3, 'test': 1}" in capsys.readouterr().out
    jax_dir = tmp_path / "jax"
    jax_dir.mkdir()
    (jax_dir / "bert_captions.pickle").write_bytes((data / "bert_captions.pickle").read_bytes())
    jax_te.build_sbert_cache(str(jax_dir), jax_cfg_from_file(cfg_path), model_path=ckpt)
    with open(data / "bert_captions.pickle", "rb") as f:
        sents = pickle.load(f)
    for mode, n in (("train", 3), ("test", 1)):
        got = np.load(data / f"sbert_cache_{mode}.npz")
        want = np.load(jax_dir / f"sbert_cache_{mode}.npz")
        assert got["token_embs"].shape == (n, MAX_LEN, HIDDEN) and len(sents[mode == "test"]) == n
        np.testing.assert_array_equal(got["attn_mask"], want["attn_mask"])
        a, b = got["token_embs"], want["token_embs"]
        ulp = np.spacing(np.maximum(np.abs(a), np.abs(b)))
        assert (np.abs(a.astype(np.float32) - b.astype(np.float32)) <= ulp).all()
        if mode == "train":  # the long caption fills T; the first does not
            assert got["attn_mask"][2].all() and not got["attn_mask"][0].all()


@pytest.mark.parametrize("cmd", ["sample", "prep-ln --build_cache"])
def test_cli_raises_the_jax_error_without_weights(empty_hub, tmp_path, cmd):
    cfg_path = _tiny_yaml(tmp_path, "ln_coco_256.yml")
    if cmd == "sample":
        argv = ["sample", "--cfg", cfg_path, "--data_dir", str(tmp_path), "--caption", "a bird",
                "--device", "cpu", "--out", str(tmp_path / "s.png")]
    else:
        argv = ["prep-ln", "--data_dir", str(tmp_path / "ln"), "--train_jsonl",
                _ln_jsonl(tmp_path / "t.jsonl", [("1", "A dog.")]), "--test_jsonl",
                _ln_jsonl(tmp_path / "v.jsonl", [("2", "A cat.")]), "--build_cache", "--cfg",
                cfg_path, "--device", "cpu"]
    with pytest.raises(RuntimeError, match=JAX_ERROR):
        cli.main(argv)


def test_cli_prep_ln_build_cache_requires_cfg(tmp_path):
    with pytest.raises(SystemExit, match="--build_cache requires --cfg"):
        cli.main(["prep-ln", "--data_dir", str(tmp_path / "ln"), "--train_jsonl",
                  _ln_jsonl(tmp_path / "t.jsonl", [("1", "A dog.")]), "--test_jsonl",
                  _ln_jsonl(tmp_path / "v.jsonl", [("2", "A cat.")]), "--build_cache"])
    assert not (tmp_path / "ln").exists()


@pytest.mark.parametrize("flags,want", [([], 0), (["--gpu", "2"], 2), (["--gpu_id", "3"], 3)])
def test_train_parses_gpu_flags(flags, want):
    args = cli.parse_args(["train", "--cfg", "x.yml", *flags])
    assert args.gpu_id == want and args.debug_nans is False
    assert cli.parse_args(["train", "--cfg", "x.yml", "--debug_nans"]).debug_nans is True


@pytest.mark.parametrize("case", ["no_card", "too_few_cards", "distributed", "picks_card"])
def test_train_gpu_selects_the_card(case, monkeypatch):
    """``--gpu N`` with ``--device cuda``: ``cuda:N`` made current; no card,
    too few cards, or N != 0 under ``--distributed`` raise before any work."""
    args = cli.parse_args(["train", "--cfg", "x.yml", "--gpu", "1"]
                          + (["--distributed"] if case == "distributed" else []))
    set_to = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: case != "no_card")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1 if case == "too_few_cards" else 2)
    monkeypatch.setattr(torch.cuda, "set_device", set_to.append)
    want = {"no_card": (RuntimeError, "no CUDA device"),
            "too_few_cards": (ValueError, r"--gpu 1: this machine has 1 CUDA"),
            "distributed": (ValueError, r"--gpu 1 with --distributed")}.get(case)
    if want is None:
        assert cli._train_device(args) == "cuda:1" and set_to == [1]
        return
    with pytest.raises(want[0], match=want[1]):
        cli.run_train(args)
    assert set_to == []


def _train_argv(tmp_path: Path, *extra: str) -> list[str]:
    return ["train", "--cfg", _tiny_yaml(tmp_path, "df_gan_sbert.yml"), "--synthetic",
            "--synthetic_len", "8", "--max_steps", "2", "--log_type", "none",
            "--save_after", "0", "--no_eval_fid", "--device", "cpu", "--output_root",
            str(tmp_path / "out"), *extra]


def test_cli_train_gpu_ignored_on_cpu_and_debug_nans_quiet(tmp_path, capsys):
    """A reference command line (``--gpu 3``) with ``--debug_nans`` on the
    CPU: two finite steps, anomaly mode off again afterwards."""
    assert cli.main(_train_argv(tmp_path, "--gpu", "3", "--debug_nans")) == 0
    metrics = ast.literal_eval(capsys.readouterr().out.strip().splitlines()[-1])
    assert metrics and all(np.isfinite(v) for v in metrics.values())
    assert not torch.is_anomaly_enabled()


def test_cli_train_debug_nans_raises_at_the_step(tmp_path, monkeypatch):
    """G's noise NaN at step 2: anomaly mode stops the step's backward, and
    the CLI raises ``FloatingPointError`` naming step 2."""
    noise = Trainer.step_noise
    monkeypatch.setattr(Trainer, "step_noise", lambda self, s: noise(self, s) * (
        float("nan") if s == 2 else 1.0))
    with pytest.raises(FloatingPointError, match=r"step 2: Function '\w+' returned nan"):
        cli.main(_train_argv(tmp_path, "--debug_nans"))
    assert not torch.is_anomaly_enabled()


@pytest.mark.parametrize("debug_nans", [True, False])
def test_trainer_debug_nans_checks_the_step_that_made_it(tmp_path, debug_nans):
    """A NaN metric of step 2 raises at step 2 (the state is at step 2, not
    3), naming it; without the flag the loop runs on, reading the metrics a
    step late as before."""
    cfg = cfg_from_file(_tiny_yaml(tmp_path, "df_gan_sbert.yml"))
    tr = Trainer(cfg, output_root=str(tmp_path / "out"), log_type="none", synthetic=True,
                 synthetic_len=16, save_after=100, eval_fid=False, num_threads=1,
                 device="cpu", debug_nans=debug_nans)
    step_fn, calls = tr.step_fn, []

    def poisoned(state, batch, noise):
        metrics = step_fn(state, batch, noise)
        calls.append(1)
        if len(calls) == 2:
            metrics["Loss_G"] = metrics["Loss_G"] * float("nan")
        return metrics

    tr.step_fn = poisoned
    if debug_nans:
        with pytest.raises(FloatingPointError, match=r"step 2: non-finite Loss_G$"):
            tr.fit(max_steps=3)
        assert tr.state.step == 2
    else:
        tr.fit(max_steps=3)
        assert tr.state.step == 3
