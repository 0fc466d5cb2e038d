"""The port's ``Trainer`` (``xmc_gan_tpu_torch/trainer.py``) and its CLI.

Whole-loop parity: the JAX package's ``Trainer`` and the port's run two
epochs of ``SyntheticDataset(len 8)`` (batch 4, so 4 steps) with
``save_after=0``, ``eval_fid=False`` and the flagship_word losses (SENT,
DISC, WORD, B_GLOBAL, RMIS, MAGP, spectral norm; N_CRITIC = 2), fp32, NCH 8,
64².  Both load the same DAMSM encoder (the JAX package's
``rnn_encoder_state_dict`` of seeded weights, as a ``.pth`` named by
``TEXT.ENCODER_DIR``); the port's G and D come from ``train_state_from_jax``
of the JAX trainer's initial state, and ``Trainer.step_noise`` is
overridden with the JAX draw (``fold_in(PRNGKey(seed + 7), step)``).  The
logged metrics and the final parameters are held to the bounds of
``tests/test_torch_train_step.py`` (metrics 2e-5 relative; every parameter
within 2 lr a step, 95% of them within lr / 20 after free-running steps;
the power-iteration vectors 1e-5).  Both write the same files.

Port-only checks here: ``fid_scalar_name``, ``step_noise``, what still
raises beside data parallelism (tensor parallelism, ``--dp`` without
``--distributed``), and the CLI's ``train``, ``train
--resume_auto``, ``eval`` and ``sample`` on the CPU.  Checkpoints, resume,
preemption and ``--watch``: ``tests/test_torch_trainer_resume.py``.
"""

import os
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train_step import (
    CLOSE_LR_FRAC,
    CLOSE_SHARE_FREE,
    METRIC_ATOL,
    METRIC_RTOL,
    UV_ATOL,
)
from torch_port_helpers import one_torch_thread, small_cfgs
from xmc_gan_tpu.models.encoder import RNNEncoder as JaxRNNEncoder
from xmc_gan_tpu.trainer import Trainer as JaxTrainer
from xmc_gan_tpu.utils.convert import rnn_encoder_state_dict
from xmc_gan_tpu_torch.cli import main
from xmc_gan_tpu_torch.parallel import make_mesh, shutdown
from xmc_gan_tpu_torch.trainer import Trainer
from xmc_gan_tpu_torch.utils.convert import (
    df_gan_discriminator_state_dict,
    df_gan_generator_state_dict,
    train_state_from_jax,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")
BS, SIZE, EMB, T, NOISE, SEED = 4, 64, 32, 8, 16, 3
EPOCHS, STEPS = 2, 4  # synthetic_len 8 at batch 4: 2 steps an epoch


def _overrides(encoder_dir: str = "", word: bool = True, n_critic: int = 2) -> dict:
    return {
        "CONFIG_NAME": "TINY",
        "TRAIN": {"NCH": 8, "NEF": 32, "NOISE_DIM": NOISE, "HE_INIT": True, "RMIS_LOSS": True,
                  "MAGP": True, "N_CRITIC": n_critic, "BATCH_SIZE": BS,
                  "ENCODER_LOSS": {"SENT": True, "DISC": True, "B_GLOBAL": True, "WORD": word},
                  "SMOOTH": {"GLOBAL": 0.0}},
        "IMG": {"SIZE": SIZE},
        "TEXT": {"EMBEDDING_DIM": EMB, "MAX_LENGTH": T, "VOCA_SIZE": 50, "ENCODER_NAME": "RNN",
                 "TYPE": "WORD", "ENCODER_DIR": encoder_dir},
        "DISC": {"SPEC_NORM": True, "IMG_MATCH": True},
    }


class Recorder:
    """A ``MetricWriter`` stand-in that keeps what it is given."""

    active = True

    def __init__(self):
        self.scalars_log, self.hists = [], []

    def scalars(self, step, values):
        self.scalars_log.append((step, dict(values)))

    def histograms(self, step, values):
        self.hists.append((step, dict(values)))

    def close(self):
        pass


def _files(root: str) -> set[str]:
    """The run's files outside ``model/`` (whose format is each package's own)."""
    out = set()
    for d, _, names in os.walk(root):
        rel = os.path.relpath(d, root)
        if rel.split(os.sep)[0] != "model":
            out |= {os.path.join(rel, n) for n in names}
    return out


def _encoder_file(jcfg, path: Path) -> str:
    """Seeded DAMSM encoder weights in the reference's names (only the
    shapes come from the JAX module)."""
    caps = jnp.zeros((1, T), jnp.int32)
    shapes = jax.eval_shape(JaxRNNEncoder(jcfg).init, jax.random.PRNGKey(0), caps)["params"]
    rng = np.random.RandomState(11)
    params = jax.tree.map(lambda s: (0.3 * rng.standard_normal(s.shape)).astype(np.float32),
                          dict(shapes))
    torch.save({k: torch.from_numpy(v) for k, v in rnn_encoder_state_dict(params).items()}, path)
    return str(path)


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    root = tmp_path_factory.mktemp("parity")
    jcfg, _ = small_cfgs(_overrides())
    enc = _encoder_file(jcfg, root / "text_encoder.pth")
    jcfg, cfg = small_cfgs(_overrides(enc))
    kw = dict(seed=SEED, log_type="none", synthetic=True, synthetic_len=8, save_after=0,
              eval_fid=False, num_threads=1)
    jtr = JaxTrainer(jcfg, output_root=str(root / "jax"), **kw)
    np_tree = lambda t: jax.tree.map(np.asarray, t)
    g0, d0, spec0 = (np_tree(jtr.state.g_params), np_tree(jtr.state.d_params),
                     np_tree(jtr.state.d_spectral))
    ptr = Trainer(cfg, output_root=str(root / "port"), device="cpu", **kw)
    ptr.state = train_state_from_jax(cfg, g0, d0, spec0, device="cpu")
    base = jax.random.PRNGKey(SEED + 7)
    ptr.step_noise = lambda gs: torch.from_numpy(np.array(
        jax.random.normal(jax.random.fold_in(base, gs), (BS, NOISE), jnp.float32)))
    jtr.writer, ptr.writer = Recorder(), Recorder()
    jm, pm = jtr.fit(max_epochs=EPOCHS), ptr.fit(max_epochs=EPOCHS)
    jtr.ckpt.wait()
    want = {"g": df_gan_generator_state_dict(np_tree(jtr.state.g_params)),
            "d": df_gan_discriminator_state_dict(np_tree(jtr.state.d_params),
                                                 np_tree(jtr.state.d_spectral))}
    return SimpleNamespace(cfg=cfg, jtr=jtr, ptr=ptr, jm=jm, pm=pm, want=want)


def _close(got: float, want: float) -> bool:
    return abs(got - want) <= METRIC_RTOL * abs(want) + METRIC_ATOL


def test_loop_metrics_match_jax(parity):
    """The returned metrics and every epoch's scalars (the last logged
    step's values; the throughput rates are each run's own)."""
    assert set(parity.pm) == set(parity.jm) and parity.pm["g_updated"] == 1.0
    assert all(_close(parity.pm[k], v) for k, v in parity.jm.items()), (parity.pm, parity.jm)
    rates = {"steps_per_sec", "images_per_sec", "images_per_sec_per_chip"}
    jlog, plog = parity.jtr.writer.scalars_log, parity.ptr.writer.scalars_log
    assert [e for e, _ in plog] == [e for e, _ in jlog] == [1, 2]
    for (_, got), (_, want) in zip(plog, jlog):
        assert set(got) == set(want)
        for k in set(want) - rates:
            assert _close(got[k], float(want[k])), (k, got[k], want[k])


def test_loop_parameters_match_jax(parity):
    opt = parity.cfg.TRAIN.OPT
    got = {"g": parity.ptr.state.g.state_dict(), "d": parity.ptr.state.d.state_dict()}
    assert parity.ptr.state.step == parity.jtr.global_step == STEPS
    for net, lr in (("g", opt.G_LR), ("d", opt.D_LR)):
        assert set(got[net]) == set(parity.want[net])
        n_all = n_close = 0
        for name, w in parity.want[net].items():
            err = (got[net][name] - w).abs()
            if name.endswith(("weight_u", "weight_v")):
                assert err.max().item() <= UV_ATOL, name
                continue
            assert err.max().item() <= 2 * lr * STEPS, name
            n_all += err.numel()
            n_close += int((err <= CLOSE_LR_FRAC * lr).sum())
        assert n_close / n_all >= CLOSE_SHARE_FREE, (net, n_close, n_all)


def test_loop_writes_the_jax_files(parity):
    jout, pout = parity.jtr.output_dir, parity.ptr.output_dir
    assert os.path.basename(pout) == os.path.basename(jout) == f"coco{SIZE}_TINY_{SEED}"
    assert _files(pout) == _files(jout)
    assert {"img/sents.txt", "img/imgs.png", "img/fake_samples_epoch_001.png",
            "img/fake_samples_epoch_002.png", "log/log.txt"} <= _files(pout)
    for name in ("img/sents.txt", "img/imgs.png"):  # the same batch, the same bytes
        assert Path(pout, name).read_bytes() == Path(jout, name).read_bytes()
    assert parity.ptr.ckpt.all_epochs() == parity.jtr.ckpt.all_epochs() == [1, 2]


# ---------------------------------------------------------------- port only


def _trainer(root, name, seed, **kw) -> Trainer:
    cfg = small_cfgs(_overrides(word=False, n_critic=1))[1]
    return Trainer(cfg, seed=seed, output_root=str(root / name), log_type="none",
                   synthetic=True, synthetic_len=16, num_threads=1, device="cpu", **kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return tmp_path_factory.mktemp("runs")


def test_fid_scalar_name_distinguishes_randinit_proxy(runs):
    tr = _trainer(runs, "fidname", 11)
    assert tr.fid_scalar_name == "FID"
    tr._fid = SimpleNamespace(pretrained=False)
    assert tr.fid_scalar_name == "FID_randinit_proxy"
    tr._fid.pretrained = True
    assert tr.fid_scalar_name == "FID"


def test_step_noise_is_a_function_of_seed_and_step(runs):
    tr = _trainer(runs, "noise", 7)
    a, b = tr.step_noise(5), tr.step_noise(5)
    assert a.shape == (BS, NOISE) and torch.equal(a, b)
    assert not torch.equal(a, tr.step_noise(6))
    assert not torch.equal(a, _trainer(runs, "noise2", 8).step_noise(5))


def test_mesh_raises_naming_the_data_parallel_slice(tmp_path):
    """A ``dp x tp`` grid that the group's size does not fill raises, naming
    tp and the world size: one process cannot hold a model axis of 2
    (``tests/test_torch_dp_trainer.py`` and ``tests/test_torch_tp_*.py``
    train on dp and dp x tp meshes)."""
    try:
        with pytest.raises(ValueError, match="tp=2 must divide the world size 1"):
            make_mesh(dp=1, tp=2, device="cpu", init_method=f"file://{tmp_path / 'store'}",
                      rank=0, world_size=1)
    finally:
        shutdown()


def test_cli_train_eval_and_sample_on_the_cpu(tmp_path, capsys):
    """``train`` (synthetic, checkpoints at epoch 1, an auto-checkpoint),
    ``train --resume_auto`` on, ``eval`` of the checkpoint (the random-init
    proxy, over one test batch) and ``sample`` from it."""
    import pickle

    import yaml

    cfg_path = tmp_path / "tiny.yml"
    cfg_path.write_text(yaml.safe_dump(_overrides(word=False, n_critic=1)))
    out = str(tmp_path / "out")
    common = ["--cfg", str(cfg_path), "--synthetic", "--synthetic_len", "8", "--device", "cpu",
              "--output_root", out]
    assert main(["train", *common, "--max_epochs", "1", "--log_type", "none",
                 "--save_after", "0", "--no_eval_fid", "--save_every_steps", "1"]) == 0
    assert "Loss_D" in capsys.readouterr().out
    model = Path(out, f"coco{SIZE}_TINY_100", "model")
    assert os.path.isfile(model / "ckpt_1.pt") and os.path.isfile(model / "auto" / "ckpt_2.pt")
    assert main(["train", *common, "--max_epochs", "2", "--log_type", "none",
                 "--save_after", "0", "--no_eval_fid", "--save_every_steps", "1",
                 "--resume_auto"]) == 0
    assert os.path.isfile(model / "ckpt_2.pt")
    capsys.readouterr()
    assert main(["eval", *common, "--resume_epoch", "1", "--num_samples", "4",
                 "--save_images"]) == 0
    printed = capsys.readouterr().out.strip().splitlines()[-1]
    assert printed.startswith("{'FID_randinit_proxy': ")
    for side in ("fake", "org"):  # the reference eval's per-key PNGs, one test batch
        pngs = os.listdir(Path(model.parent, "img", "eval_001", side))
        assert len(pngs) == BS and all(p.endswith(".png") for p in pngs)
    data = tmp_path / "data"
    data.mkdir()
    i2w = {i: f"w{i}" for i in range(50)}
    with open(data / "captions.pickle", "wb") as f:
        pickle.dump(([], [], i2w, {v: k for k, v in i2w.items()}), f)
    png = str(tmp_path / "s.png")
    assert main(["sample", "--cfg", str(cfg_path), "--data_dir", str(data), "--caption",
                 "w3 w4 w5", "--device", "cpu", "--output_root", out, "--out", png,
                 "--n_per_caption", "2"]) == 0
    assert os.path.getsize(png) > 0


def test_d_warm_start_from_a_reference_checkpoint(runs):
    """``DISC.ENCODER_DIR``: a reference ``NetD`` state_dict (torch
    ``spectral_norm``'s ``weight_orig`` names) loads into D where names and
    shapes match; the rest keeps its initial values (strict=False)."""
    src = _trainer(runs, "warm_src", 41).state.d.state_dict()
    ref = {(k[: -len("weight")] + "weight_orig" if k.endswith("conv_img.weight") else k): v + 1
           for k, v in src.items()}
    ref["not_in_d.weight"] = torch.zeros(3)
    path = str(runs / "netD_ref.pth")
    torch.save(ref, path)
    over = _overrides(word=False, n_critic=1)
    over["DISC"] = {**over["DISC"], "ENCODER_DIR": path}
    cfg = small_cfgs(over)[1]
    tr = Trainer(cfg, seed=42, output_root=str(runs / "warm"), log_type="none", synthetic=True,
                 synthetic_len=16, num_threads=1, device="cpu")
    got = tr.state.d.state_dict()
    assert all(torch.equal(got[k], v + 1) for k, v in src.items())


def test_cli_data_parallel_flags_raise():
    """``--tp 2`` and ``--dp 2`` without ``--distributed`` raise (one process
    drives one card; the ranks come from torchrun; ``--tp`` itself runs,
    ``tests/test_torch_tp_trainer.py``)."""
    common = ["train", "--cfg", "xmc_gan_tpu/cfg/df_gan_damsm.yml", "--synthetic", "--device",
              "cpu"]
    with pytest.raises(ValueError, match="--nproc_per_node 2 and --distributed"):
        main([*common, "--tp", "2"])
    with pytest.raises(ValueError, match="--nproc_per_node 2 and --distributed"):
        main([*common, "--dp", "2"])
