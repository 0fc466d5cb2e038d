"""The training program under tensor parallelism: ``Trainer(mesh=...)`` with
``tp`` = 2 and ``cli train --distributed --tp 2`` on gloo ranks on the CPU
(``tests/torch_dp_workers.py``), at ``tests/test_torch_dp_trainer.py``'s
tiny flagship_word configuration (64², a global batch of 4) with NCH 16,
where the JAX rule's threshold (2^16) splits 5 of G's convs and 5 of D's.

* ``Trainer.fit`` for one epoch on ``dp = 1 x tp = 2``: the ranks agree
  on the metrics (finite) and on the FID of the split G, and rank 0 writes
  the epoch's checkpoint once, as the whole state.
* The checkpoint round trip: the ``tp = 2`` checkpoint restores into a
  one-process ``Trainer`` with tensors equal to the state the ranks
  gathered (parameters, vectors, Adam moments, step), and a one-process
  checkpoint restores under ``tp = 2`` with tensors equal to the file's.
* ``cli train --distributed --tp 2`` under torchrun's environment
  variables: one epoch of one step, the split counted in rank 0's log, the
  checkpoint loading strictly into a one-process state.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from test_torch_dp_trainer import OVERRIDES as DP_OVERRIDES
from test_torch_dp_trainer import SEED, SIZE, _free_port
from torch_dp_workers import JOIN_TIMEOUT_S, REPO, launch
from torch_port_helpers import one_torch_thread  # noqa: F401  (fixture)
from xmc_gan_tpu_torch.config import cfg_from_dict
from xmc_gan_tpu_torch.train import create_train_state
from xmc_gan_tpu_torch.trainer import Trainer
from xmc_gan_tpu_torch.utils.checkpoint import CheckpointManager

SYNTHETIC_LEN = 8
OVERRIDES = {**DP_OVERRIDES, "TRAIN": {**DP_OVERRIDES["TRAIN"], "NCH": 16}}
KW = dict(seed=SEED, log_type="none", synthetic=True, synthetic_len=SYNTHETIC_LEN,
          num_threads=1, device="cpu", save_after=0, eval_fid=False)


def _run_dir(root) -> Path:
    return Path(root, f"coco{SIZE}_TINY_DP_{SEED}")


@pytest.fixture(scope="module")
def run(one_torch_thread, tmp_path_factory):
    root = tmp_path_factory.mktemp("tp_trainer")
    cfg = cfg_from_dict(OVERRIDES)
    one = Trainer(cfg, output_root=str(root / "one"), **KW)
    one.fit(max_epochs=1)
    ranks = launch("tp_trainer", root / "work", 2, spec={
        "overrides": OVERRIDES, "seed": SEED, "root": str(root / "tp"), "tp": 2,
        "synthetic_len": SYNTHETIC_LEN, "fid_samples": 1000,
        "one_root": str(root / "one")})
    return {"root": root, "cfg": cfg, "ranks": ranks,
            "one": CheckpointManager(_run_dir(root / "one") / "model").load(1)[0]}


def _assert_same_state(got: dict, want: dict) -> None:
    assert got["step"] == want["step"]
    for net in ("g", "d"):
        assert got[net].keys() == want[net].keys()
        for name, v in want[net].items():
            assert torch.equal(got[net][name].cpu(), v.cpu()), (net, name)
        g_opt, w_opt = got[f"{net}_opt"]["state"], want[f"{net}_opt"]["state"]
        assert g_opt.keys() == w_opt.keys()
        for i, s in w_opt.items():
            for key, v in s.items():
                assert torch.equal(torch.as_tensor(g_opt[i][key]).cpu(),
                                   torch.as_tensor(v).cpu()), (net, i, key)


def test_tp_trainer_fit_and_fid(run):
    a, b = run["ranks"]
    assert a["fit"] == b["fit"]
    assert all(np.isfinite(v) for v in a["fit"].values()) and a["fit"]["g_updated"] == 1.0
    assert a["fid"] == b["fid"] and np.isfinite(a["fid"])
    assert os.listdir(_run_dir(run["root"] / "tp") / "model") == ["ckpt_1.pt"]
    _assert_same_state(b["state"], a["state"])


def test_tp_checkpoint_restores_into_one_process(run):
    tr = Trainer(run["cfg"], output_root=str(run["root"] / "tp"), **KW)
    assert tr.resume(1) == 1
    _assert_same_state(CheckpointManager.payload(tr.state), run["ranks"][0]["state"])


def test_one_process_checkpoint_restores_under_tp(run):
    for r in run["ranks"]:
        assert r["resumed_at"] == 1
        _assert_same_state(r["resumed"], run["one"])


def test_cli_train_tp_distributed(tmp_path):
    """``train --tp 2 --distributed`` as torchrun starts it: two processes
    with ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
    ``MASTER_PORT`` set, killed after the join timeout if they hang."""
    cfg_path = tmp_path / "tiny.yml"
    cfg_path.write_text(yaml.safe_dump(OVERRIDES))
    out = tmp_path / "out"
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1", "WORLD_SIZE": "2",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port())}
    args = [sys.executable, "-m", "xmc_gan_tpu_torch.cli", "train", "--cfg", str(cfg_path),
            "--synthetic", "--synthetic_len", "4", "--device", "cpu", "--tp", "2",
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
    split = [line for line in logs[0].splitlines() if "tp=2: " in line]
    assert split and not split[0].split("tp=2: ")[1].startswith("0 "), logs[0]
    assert logs[0].strip().splitlines()[-1].startswith("{'Loss_D': ")
    model = out / f"coco{SIZE}_TINY_DP_100" / "model"
    assert os.listdir(model) == ["ckpt_1.pt"]
    payload = torch.load(model / "ckpt_1.pt", weights_only=True)
    state = create_train_state(cfg_from_dict(OVERRIDES), device="cpu")
    state.g.load_state_dict(payload["g"], strict=True)
    state.d.load_state_dict(payload["d"], strict=True)
    state.g_opt.load_state_dict(payload["g_opt"])
    state.d_opt.load_state_dict(payload["d_opt"])
