"""The training program under data parallelism: ``Trainer(mesh=...)`` and
``cli train --dp 2 --distributed`` on two gloo ranks on the CPU
(``tests/torch_dp_workers.py``), at NCH 4, 64², a global batch of 4 and the
flagship_word losses (SENT, DISC, WORD, B_GLOBAL, RMIS, MAGP, spectral norm).

* ``Trainer.fit``, 2 epochs of 4 steps (each rank loads its shard of 2 rows a
  step): the replicas bit-equal, the losses finite, the epoch checkpoints
  and the auto-checkpoints written once (rank 0), and an exact resume: a
  fresh ``Trainer`` of the same run resumes from the step-3 auto-checkpoint
  and ends bit-equal to the uninterrupted run.
* The FID statistics: each rank scores its test shard; the all-reduced real
  statistics equal one process's over the same images, and the all-reduced
  fake statistics the sum of the ranks' own.
* ``cli train`` under torchrun's environment variables (``env://``), two
  subprocesses: one checkpoint, the console lines on rank 0.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from torch_dp_workers import JOIN_TIMEOUT_S, REPO, launch
from torch_port_helpers import one_torch_thread  # noqa: F401  (fixture)
from xmc_gan_tpu_torch.config import cfg_from_dict
from xmc_gan_tpu_torch.data.pipeline import DataLoader, SyntheticDataset
from xmc_gan_tpu_torch.eval import FidComputer

BS, SIZE, SYNTHETIC_LEN, EPOCHS, SEED = 4, 64, 16, 2, 5
STEPS_PER_EPOCH = SYNTHETIC_LEN // BS
OVERRIDES = {
    "CONFIG_NAME": "TINY_DP",
    "TRAIN": {"NCH": 4, "NEF": 16, "NOISE_DIM": 8, "HE_INIT": True, "RMIS_LOSS": True,
              "MAGP": True, "N_CRITIC": 1, "BATCH_SIZE": BS, "LOG_INTERVAL": 1000,
              "ENCODER_LOSS": {"SENT": True, "DISC": True, "B_GLOBAL": True, "WORD": True},
              "SMOOTH": {"GLOBAL": 0.0}},
    "IMG": {"SIZE": SIZE},
    "TEXT": {"EMBEDDING_DIM": 16, "VOCA_SIZE": 40, "MAX_LENGTH": 6, "ENCODER_DIR": ""},
    "DISC": {"SPEC_NORM": True, "IMG_MATCH": True},
}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_trainer")
    out = launch("trainer", root / "work", 2, spec={
        "overrides": OVERRIDES, "seed": SEED, "root": str(root / "out"),
        "synthetic_len": SYNTHETIC_LEN, "epochs": EPOCHS, "save_every_steps": 3,
        "resume_step": 3, "fid_samples": 1000})
    return {"root": root / "out", "out": out}


def _equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(v, b[k]) for k, v in a.items())


def test_trainer_replicas_are_bit_equal(ranks):
    a, b = (r["state"] for r in ranks["out"])
    assert a["step"] == b["step"] == EPOCHS * STEPS_PER_EPOCH
    assert _equal(a["g"], b["g"]) and _equal(a["d"], b["d"])
    fit = ranks["out"][0]["fit"]
    assert fit == ranks["out"][1]["fit"]
    assert all(np.isfinite(v) for v in fit.values()) and fit["g_updated"] == 1.0


def test_trainer_writes_each_checkpoint_once(ranks):
    run = Path(ranks["root"], f"coco{SIZE}_TINY_DP_{SEED}")
    assert sorted(os.listdir(run / "model")) == ["auto", "ckpt_1.pt", "ckpt_2.pt"]
    assert ranks["out"][0]["epochs"] == [1, 2]
    assert ranks["out"][0]["auto_steps"] == ranks["out"][1]["auto_steps"] == [3, 6]
    assert {"sents.txt", "imgs.png", "fake_samples_epoch_001.png"} <= set(os.listdir(run / "img"))


def test_trainer_resume_is_exact(ranks):
    for r in ranks["out"]:
        assert r["resumed_at"] == 3
        assert r["resumed"]["step"] == r["state"]["step"]
        assert _equal(r["resumed"]["g"], r["state"]["g"])
        assert _equal(r["resumed"]["d"], r["state"]["d"])
        assert r["resumed_fit"] == r["fit"]


def test_fid_statistics_are_the_global_ones(ranks, one_torch_thread):
    a, b = (r["fid_stats"] for r in ranks["out"])
    for key in ("real", "fake"):
        for x, y in zip(a[key], b[key]):
            np.testing.assert_array_equal(x, y)
    # the real statistics: one process over the same test images, in the
    # ranks' batches and on one thread as they are (the extractor's fp32
    # sums depend on both)
    cfg = cfg_from_dict(OVERRIDES)
    test_set = SyntheticDataset(cfg, max(SYNTHETIC_LEN // 4, 8), "test")
    fid = FidComputer(device="cpu")
    one = fid.stats()
    for rank in range(2):
        for batch in DataLoader(test_set, BS, drop_last=True, seed=SEED, num_threads=1,
                                shard=(rank, 2)):
            fid.update(one, batch["imgs"])
    assert one.n == len(test_set)
    for got, want in zip(a["real"], one.finalize()):
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)
    # the fake statistics: the ranks' own sums, combined
    n = sum(r["fid_stats"]["fake_local"][0] for r in ranks["out"])
    s = sum(r["fid_stats"]["fake_local"][1] for r in ranks["out"]).numpy()
    o = sum(r["fid_stats"]["fake_local"][2] for r in ranks["out"]).numpy()
    assert n == len(test_set)
    mu = s / n
    np.testing.assert_allclose(a["fake"][0], mu, rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(a["fake"][1], (o - n * np.outer(mu, mu)) / (n - 1),
                               rtol=1e-12, atol=1e-15)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_train_dp_distributed(tmp_path):
    """``train --dp 2 --distributed`` as torchrun starts it: two processes
    with ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
    ``MASTER_PORT`` set, killed after the join timeout if they hang."""
    cfg_path = tmp_path / "tiny.yml"
    cfg_path.write_text(yaml.safe_dump(OVERRIDES))
    out = tmp_path / "out"
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1", "WORLD_SIZE": "2",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port())}
    args = [sys.executable, "-m", "xmc_gan_tpu_torch.cli", "train", "--cfg", str(cfg_path),
            "--synthetic", "--synthetic_len", "8", "--device", "cpu", "--dp", "2",
            "--distributed", "--max_epochs", "1", "--log_type", "none", "--save_after", "0",
            "--no_eval_fid", "--output_root", str(out)]
    procs = [subprocess.Popen(args, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env={**env, "RANK": str(r), "LOCAL_RANK": str(r)})
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=JOIN_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], logs
    assert "Loss_D" in logs[0] and "Loss_D" not in logs[1]
    assert logs[0].strip().splitlines()[-1].startswith("{'Loss_D': ")
    model = out / f"coco{SIZE}_TINY_DP_100" / "model"
    assert os.listdir(model) == ["ckpt_1.pt"]
