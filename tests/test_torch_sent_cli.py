"""SENT (SBERT) configs through the port's command line on the CPU:
``cli train`` then ``cli eval`` on a tiny SENT dataset directory built in
``tmp_path`` (JPEGs, ``{train,test}/filenames.pickle``,
``bert_captions.pickle`` and both ``sbert_cache_{mode}.npz``), so that
``Trainer.fit`` reads images, captions and token embeddings from disk;
``cli train --synthetic`` for ``concept_out_df_gan.yml``,
``df_gan_sbert_seperate.yml`` and ``ln_coco_256.yml``; and ``sample``
refusing a SENT config, naming the RoBERTa weights, where the HF hub cache
has none (``tests/test_torch_cli_sent.py`` samples with them).  Each YAML is the shipped file at
tiny width (NCH=4, NEF=16, EMBEDDING_DIM=24, MAX_LENGTH=6, every switch
kept)."""

import ast
import pickle
from pathlib import Path

import numpy as np
import pytest
import yaml
from PIL import Image

from torch_port_helpers import one_torch_thread  # noqa: F401  (fixture)
from xmc_gan_tpu_torch import cli
from xmc_gan_tpu_torch.trainer import run_dir

pytestmark = pytest.mark.usefixtures("one_torch_thread")
CFG_DIR = Path(__file__).resolve().parents[1] / "xmc_gan_tpu" / "cfg"
EMB, T = 24, 6


def _tiny_yaml(tmp_path: Path, name: str) -> str:
    with open(CFG_DIR / name) as f:
        doc = yaml.safe_load(f)
    doc["TRAIN"].update({"NCH": 4, "NEF": 16, "NOISE_DIM": 8, "NUM_WORKERS": 2,
                         "LOG_INTERVAL": 1})
    doc["TEXT"].update({"EMBEDDING_DIM": EMB, "MAX_LENGTH": T, "VOCA_SIZE": 40})
    path = tmp_path / name
    path.write_text(yaml.safe_dump(doc))
    return str(path)


@pytest.fixture()
def sent_dataset(tmp_path):
    """8 train and 4 test images, one caption each (``ln_coco_256.yml``:
    CAPTIONS_PER_IMAGE 1), the caches' rows the captions' token embeddings
    (fp16) and masks (uint8), one test caption with no real token."""
    root = tmp_path / "ln"
    rng = np.random.RandomState(0)
    (root / "images").mkdir(parents=True)
    sents = {}
    for mode, n in (("train", 8), ("test", 4)):
        names = [f"{mode}_{i:03d}" for i in range(n)]
        for name in names:
            Image.fromarray(rng.randint(0, 255, (80, 72, 3), np.uint8)).save(
                root / "images" / f"{name}.jpg")
        (root / mode).mkdir()
        with open(root / mode / "filenames.pickle", "wb") as f:
            pickle.dump(names, f)
        sents[mode] = [f"a photo number {i} of {mode}" for i in range(n)]
        attn = (np.arange(T)[None, :] < rng.randint(1, T + 1, n)[:, None]).astype(np.uint8)
        if mode == "test":
            attn[2] = 0
        np.savez(root / f"sbert_cache_{mode}.npz",
                 token_embs=rng.randn(n, T, EMB).astype(np.float16), attn_mask=attn)
    with open(root / "bert_captions.pickle", "wb") as f:
        pickle.dump((sents["train"], sents["test"]), f)
    return root


def test_cli_train_then_eval_reads_a_sent_dataset_from_disk(sent_dataset, tmp_path, capsys):
    """``ln_coco_256.yml`` (SENT + DISC + WORD + B_GLOBAL, spectral norm,
    IMG_MATCH, BERT_NORM): one epoch of 2 steps from the JPEGs and the
    train cache, a checkpoint, then the FID eval of it over the test split
    (the random-init Inception proxy)."""
    cfg_path = _tiny_yaml(tmp_path, "ln_coco_256.yml")
    out = tmp_path / "out"
    common = ["--cfg", cfg_path, "--data_dir", str(sent_dataset), "--bs", "4", "--imsize", "64",
              "--device", "cpu", "--output_root", str(out)]
    assert cli.main(["train", *common, "--max_epochs", "1", "--log_type", "none",
                     "--save_after", "0", "--no_eval_fid"]) == 0
    metrics = ast.literal_eval(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"Loss_D", "Loss_G", "ds_word", "gs_word"} <= set(metrics)
    assert all(np.isfinite(v) for v in metrics.values())
    cfg = cli._cfg(cli.parse_args(["train", "--cfg", cfg_path, "--imsize", "64"]))
    run = Path(run_dir(cfg, str(out), 100))
    assert (run / "model" / "ckpt_1.pt").is_file() and (run / "img" / "sents.txt").is_file()
    assert "a photo number" in (run / "img" / "sents.txt").read_text()
    assert cli.main(["eval", *common, "--num_samples", "4"]) == 0
    (name, value), = ast.literal_eval(capsys.readouterr().out.strip().splitlines()[-1]).items()
    assert name == "FID_randinit_proxy" and np.isfinite(value)


@pytest.mark.parametrize("name", ["concept_out_df_gan.yml", "df_gan_sbert_seperate.yml",
                                  "ln_coco_256.yml"])
def test_cli_train_synthetic_sent_configs(tmp_path, capsys, name):
    """One synthetic epoch of 2 steps with the seeded token-embedding table."""
    args = ["train", "--cfg", _tiny_yaml(tmp_path, name), "--synthetic", "--synthetic_len", "8",
            "--bs", "4", "--imsize", "64", "--max_epochs", "1", "--log_type", "none",
            "--save_after", "0", "--no_eval_fid", "--device", "cpu",
            "--output_root", str(tmp_path / "out")]
    assert cli.main(args) == 0
    metrics = ast.literal_eval(capsys.readouterr().out.strip().splitlines()[-1])
    assert metrics and all(np.isfinite(v) for v in metrics.values())


def test_cli_sample_refuses_sent_configs_naming_roberta(sent_dataset, tmp_path, monkeypatch):
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "empty_hub"))
    with pytest.raises(RuntimeError, match="sentence-transformers/stsb-roberta-base' weights"):
        cli.main(["sample", "--cfg", _tiny_yaml(tmp_path, "df_gan_sbert.yml"), "--data_dir",
                  str(sent_dataset), "--caption", "a red bird", "--device", "cpu"])
