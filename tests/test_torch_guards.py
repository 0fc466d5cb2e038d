"""Guards of the port: it stands alone (no JAX, nothing of the JAX package),
its entry points run on the card unless the caller asks for the CPU, and the
kernel wrapper never falls back quietly."""

import ast
import importlib
import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import xmc_gan_tpu_torch
from xmc_gan_tpu_torch.config import cfg_from_dict
from xmc_gan_tpu_torch.device import resolve_device
from xmc_gan_tpu_torch import losses
from xmc_gan_tpu_torch.ops.cuda import cross_attention as ca
from xmc_gan_tpu_torch.ops.cuda import damsm_score as ds
from xmc_gan_tpu_torch.ops.cuda import fused_affine as fa
from xmc_gan_tpu_torch.train import (
    create_train_state,
    make_generator,
    make_sample_fn,
    make_train_step,
)
from xmc_gan_tpu_torch.trainer import Trainer, make_encode_fn

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "xmc_gan_tpu_torch"
MODULES = sorted(m.name for m in pkgutil.walk_packages(xmc_gan_tpu_torch.__path__,
                                                       "xmc_gan_tpu_torch."))
TINY = {"TRAIN": {"NCH": 4, "NEF": 16, "NOISE_DIM": 8}, "IMG": {"SIZE": 64},
        "TEXT": {"EMBEDDING_DIM": 16, "VOCA_SIZE": 30, "MAX_LENGTH": 5, "ENCODER_DIR": ""}}


def _forbidden(name: str) -> bool:
    """``jax`` and ``xmc_gan_tpu`` with their submodules; ``xmc_gan_tpu_torch``
    only shares the JAX package's name as a prefix and is allowed."""
    return any(name == top or name.startswith(top + ".") for top in ("jax", "xmc_gan_tpu"))


def test_forbidden_matches_modules_not_prefixes():
    assert _forbidden("jax") and _forbidden("jax.numpy") and _forbidden("xmc_gan_tpu.ops")
    assert not _forbidden("xmc_gan_tpu_torch") and not _forbidden("jaxtyping")


def test_every_port_module_imports_without_jax_or_the_jax_package():
    """A fresh interpreter imports every module of the port; afterwards
    neither ``jax`` nor ``xmc_gan_tpu``/``xmc_gan_tpu.*`` is loaded."""
    code = (
        "import importlib, json, sys\n"
        f"names = {MODULES!r}\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120, check=True)
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(MODULES) <= set(loaded)
    assert [m for m in loaded if _forbidden(m)] == []


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")), ids=lambda p: str(p.relative_to(PORT)))
def test_port_sources_name_no_forbidden_import(path):
    """The same rule read off the source, lazy imports inside functions included."""
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    assert [n for n in names if _forbidden(n)] == []


def test_chip_smoke_imports_neither_jax_nor_the_jax_package():
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    assert [n for n in names if _forbidden(n)] == []


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _caption_batch():
    caps = np.array([[3, 4, 5, 0, 0], [7, 8, 0, 0, 0]], np.int64)
    return {"caps": caps, "cap_lens": (caps != 0).sum(1)}


@pytest.mark.parametrize("entry", ["resolve_device", "make_encode_fn", "make_generator",
                                   "make_sample_fn", "create_train_state"])
def test_entry_points_run_on_cuda_unless_cpu_is_asked(entry, no_cuda):
    """No GPU and no explicit CPU request: raise, never fall back."""
    cfg = cfg_from_dict(TINY)
    call = {
        "resolve_device": lambda **kw: resolve_device(**kw),
        "make_encode_fn": lambda **kw: make_encode_fn(cfg, **kw),
        "make_generator": lambda **kw: make_generator(cfg, **kw),
        "make_sample_fn": lambda **kw: make_sample_fn(cfg, **kw),
        "create_train_state": lambda **kw: create_train_state(cfg, **kw),
    }[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call(device="cuda")
    call(device="cpu")


def test_cpu_request_runs_the_whole_path(no_cuda):
    cfg = cfg_from_dict(TINY)
    words, sent, mask = make_encode_fn(cfg, device="cpu")(_caption_batch())
    img = make_sample_fn(cfg, device="cpu")(np.zeros((2, 8), np.float32), sent, words, mask)
    assert img.shape == (2, 64, 64, 3) and img.device.type == "cpu"


def test_train_step_runs_where_the_state_is(no_cuda):
    """``make_train_step`` takes no device: the step runs on the state's, which
    ``create_train_state`` put on the card unless the CPU was asked for."""
    cfg = cfg_from_dict({**TINY, "TRAIN": {**TINY["TRAIN"], "MAGP": True}})
    state = create_train_state(cfg, device="cpu")
    rng = np.random.RandomState(0)
    batch = {"imgs": rng.randint(0, 256, (2, 64, 64, 3)).astype(np.uint8),
             "sent_embs": rng.randn(2, 16).astype(np.float32)}
    metrics = make_train_step(cfg)(state, batch, rng.randn(2, 8).astype(np.float32))
    assert state.step == 1
    assert all(v.device.type == "cpu" and bool(torch.isfinite(v.float())) for v in metrics.values())


def _tiny_yaml(tmp_path) -> str:
    import yaml

    path = tmp_path / "tiny.yml"
    path.write_text(yaml.safe_dump({**TINY, "CONFIG_NAME": "TINY",
                                    "TRAIN": {**TINY["TRAIN"], "BATCH_SIZE": 2}}))
    return str(path)


@pytest.mark.parametrize("entry", ["Trainer", "FidComputer", "cli train"])
def test_training_entry_points_run_on_cuda_unless_cpu_is_asked(entry, no_cuda, tmp_path):
    """The trainer, the FID extractor and the CLI's ``train``: no GPU and no
    explicit CPU request raises; with ``device="cpu"`` each runs whole (one
    train step with its grid and checkpoint; features of a batch)."""
    from xmc_gan_tpu_torch import cli
    from xmc_gan_tpu_torch.eval import FidComputer

    cfg = cfg_from_dict({**TINY, "TRAIN": {**TINY["TRAIN"], "BATCH_SIZE": 2}})
    out = str(tmp_path / "out")

    def trainer(**kw):
        tr = Trainer(cfg, output_root=out, log_type="none", synthetic=True, synthetic_len=4,
                     save_after=0, eval_fid=False, num_threads=1, **kw)
        metrics = tr.fit(max_epochs=1)
        assert np.isfinite(metrics["Loss_D"]) and tr.ckpt.all_epochs() == [1]

    def fid(**kw):
        f = FidComputer(**kw)
        feats = f.features(np.zeros((2, 32, 32, 3), np.uint8))
        assert feats.shape == (2, 2048) and bool(torch.isfinite(feats).all())

    def train_cli(**kw):
        argv = ["train", "--cfg", _tiny_yaml(tmp_path), "--synthetic", "--synthetic_len", "4",
                "--max_steps", "1", "--log_type", "none", "--no_eval_fid", "--save_after", "0",
                "--output_root", out]
        assert cli.main(argv + [f"--device={kw['device']}"] if kw else argv) == 0

    call = {"Trainer": trainer, "FidComputer": fid, "cli train": train_cli}[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call(device="cuda")
    call(device="cpu")


def test_unsupported_device_raises():
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def test_kernel_wrapper_has_no_quiet_route_for_other_devices():
    """Only a CPU tensor takes the plain version; any other device that is
    not CUDA raises rather than computing somewhere else."""
    x = torch.empty(2, 8, 4, 4, device="meta").contiguous(memory_format=torch.channels_last)
    g = torch.empty(2, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU tensors"):
        fa.double_modulate_lrelu_kernel(x, g, g, g, g)


def test_damsm_wrapper_has_no_quiet_route_for_other_devices():
    """The same for the word-score kernels, also when the train step's loss
    asks for them explicitly."""
    r = torch.empty(2, 5, 8, device="meta")
    w = torch.empty(3, 4, 8, device="meta")
    m = torch.zeros(3, 4, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU tensors"):
        ds.damsm_scores(r, w, m)
    with pytest.raises(ValueError, match="CUDA or CPU tensors"):
        losses.word_region_scores(r, w, m, backend="kernel")


def test_cross_attention_wrapper_has_no_quiet_route():
    """A tensor on any device other than the CPU or CUDA raises; a CUDA path
    never takes the plain version (the launch is reached and, without a
    card or a built library, raises instead of computing on the CPU); a
    CPU tensor never launches."""
    q = torch.empty(2, 3, 4, device="meta")
    m = torch.zeros(2, 5, dtype=torch.bool, device="meta")
    k = torch.empty(2, 5, 4, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU tensors"):
        ca.masked_cross_attention_kernel(q, k, k, m)

    class Reached(Exception):
        pass

    def launch(*args):
        raise Reached

    def plain(*args):
        raise AssertionError("a CUDA tensor took the plain version")

    qc, kc = torch.zeros(2, 3, 4), torch.zeros(2, 5, 4)
    mc = torch.zeros(2, 5, dtype=torch.bool)
    real_device = torch.Tensor.device
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ca, "_launch", launch)
        mp.setattr(ca, "masked_cross_attention_ref", plain)
        mp.setattr(torch.Tensor, "device", property(lambda t: torch.device("cuda")))
        with pytest.raises(Reached):
            ca.masked_cross_attention_kernel(qc, kc, kc, mc)
        # an operand that would need a gradient is refused on CUDA, not detached
        with pytest.raises(NotImplementedError, match="word-attention training slice"):
            ca.masked_cross_attention_kernel(qc.clone().requires_grad_(), kc, kc, mc)
    assert torch.Tensor.device is real_device
    before = ca.FORWARD.launches
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ca, "_launch", launch)
        ca.masked_cross_attention_kernel(qc, kc, kc, mc)
    assert ca.FORWARD.launches == before


def test_modules_list_covers_the_slice():
    want = {"config", "device", "registry", "trainer", "train", "cli", "losses",
            "ops.initializers", "ops.modules", "ops.fused", "ops.images", "ops.cuda.build",
            "ops.cuda.fused_affine", "ops.cuda.damsm_score", "ops.cuda.cross_attention",
            "ops.cross_attention", "ops.grouped", "models.common", "models.df_gan",
            "models.df_concept_gan", "models.concept_gan", "models.encoder", "utils.convert",
            "utils.miscc", "data.vocab", "data.pipeline", "data.native", "data.toy",
            "utils.checkpoint", "utils.logger", "models.inception", "eval", "data.text_encode"}
    assert {f"xmc_gan_tpu_torch.{m}" for m in want} <= set(MODULES)
    for name in MODULES:
        importlib.import_module(name)
