"""Guards of the port: it stands alone (no JAX, nothing of the JAX package),
its entry points run on the card unless the caller asks for the CPU, and the
kernel wrapper never falls back quietly."""

import ast
import importlib
import json
import os
import pickle
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
from xmc_gan_tpu_torch.data import text_encode as te
from xmc_gan_tpu_torch.data.bpe import bytes_to_unicode
from xmc_gan_tpu_torch.models.roberta import RobertaConfig, RobertaModel, save_roberta

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "xmc_gan_tpu_torch"
MODULES = sorted(m.name for m in pkgutil.walk_packages(xmc_gan_tpu_torch.__path__,
                                                       "xmc_gan_tpu_torch."))
TINY = {"TRAIN": {"NCH": 4, "NEF": 16, "NOISE_DIM": 8}, "IMG": {"SIZE": 64},
        "TEXT": {"EMBEDDING_DIM": 16, "VOCA_SIZE": 30, "MAX_LENGTH": 5, "ENCODER_DIR": ""}}


# packages the card's machine does not have (the SBERT encoding functions read the
# checkpoint with torch and tokenize in plain Python)
CARD_LACKS = ("transformers", "tokenizers", "regex", "safetensors")


def _forbidden(name: str) -> bool:
    """``jax`` and ``xmc_gan_tpu`` with their submodules, and the packages
    the card lacks; ``xmc_gan_tpu_torch`` only shares the JAX package's name
    as a prefix and is allowed."""
    return any(name == top or name.startswith(top + ".")
               for top in ("jax", "xmc_gan_tpu", *CARD_LACKS))


def test_forbidden_matches_modules_not_prefixes():
    assert _forbidden("jax") and _forbidden("jax.numpy") and _forbidden("xmc_gan_tpu.ops")
    assert not _forbidden("xmc_gan_tpu_torch") and not _forbidden("jaxtyping")
    assert _forbidden("transformers.models") and _forbidden("regex") and _forbidden("tokenizers")
    assert _forbidden("safetensors.torch") and not _forbidden("regex_extra")


def test_every_port_module_imports_without_jax_or_the_jax_package():
    """A fresh interpreter imports every module of the port; afterwards
    neither ``jax`` nor ``xmc_gan_tpu``/``xmc_gan_tpu.*`` is loaded, nor any
    of ``CARD_LACKS``."""
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
                                   "make_sample_fn", "create_train_state", "export_sampler"])
def test_entry_points_run_on_cuda_unless_cpu_is_asked(entry, no_cuda):
    """No GPU and no explicit CPU request: raise, never fall back."""
    from xmc_gan_tpu_torch.utils.export import export_sampler

    cfg = cfg_from_dict(TINY)
    call = {
        "resolve_device": lambda **kw: resolve_device(**kw),
        "make_encode_fn": lambda **kw: make_encode_fn(cfg, **kw),
        "make_generator": lambda **kw: make_generator(cfg, **kw),
        "make_sample_fn": lambda **kw: make_sample_fn(cfg, **kw),
        "create_train_state": lambda **kw: create_train_state(cfg, **kw),
        "export_sampler": lambda **kw: export_sampler(cfg, **kw),
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


@pytest.mark.parametrize("entry", ["Trainer", "FidComputer", "cli train", "cli export-sampler"])
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

    def export_cli(**kw):
        argv = ["export-sampler", "--cfg", _tiny_yaml(tmp_path), "--out", out + ".pt2"]
        assert cli.main(argv + [f"--device={kw['device']}"] if kw else argv) == 0

    call = {"Trainer": trainer, "FidComputer": fid, "cli train": train_cli,
            "cli export-sampler": export_cli}[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call(device="cuda")
    call(device="cpu")


def _tiny_roberta(path) -> str:
    """A 1-layer RoBERTa checkpoint (hidden 16) written by the port itself:
    the byte symbols, one merge."""
    b2u = bytes_to_unicode()
    vocab = {t: i for i, t in enumerate(["<s>", "<pad>", "</s>", "<unk>"])}
    for tok in [*b2u.values(), "\u0120b", "<mask>"]:
        vocab.setdefault(tok, len(vocab))
    torch.manual_seed(0)
    model = RobertaModel(RobertaConfig(vocab_size=len(vocab), hidden_size=16,
                                       num_hidden_layers=1, num_attention_heads=2,
                                       intermediate_size=32, max_position_embeddings=16))
    return save_roberta(str(path), model, vocab, [("\u0120", "b")])


@pytest.mark.parametrize("entry", ["make_hf_sbert_encode", "build_sbert_cache", "cli sample",
                                   "cli prep-ln --build_cache"])
def test_sbert_encoding_runs_on_cuda_unless_cpu_is_asked(entry, no_cuda, tmp_path, monkeypatch):
    """The SBERT encode and cache functions and the CLI commands that call them: no GPU and no
    explicit CPU request raises; with the CPU asked for, each runs whole
    (``stsb-roberta-base`` from the hub cache where no path is given)."""
    import yaml
    from xmc_gan_tpu_torch import cli

    ckpt = _tiny_roberta(tmp_path / "ckpt")
    repo = tmp_path / "hub" / "models--sentence-transformers--stsb-roberta-base"
    for d in ("refs", "snapshots"):
        (repo / d).mkdir(parents=True)
    (repo / "refs" / "main").write_text("c0ffee")
    os.symlink(ckpt, repo / "snapshots" / "c0ffee")
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    text = {"TYPE": "SENT", "ENCODER_NAME": "SBERT", "EMBEDDING_DIM": 16, "MAX_LENGTH": 6}
    cfg = cfg_from_dict({**TINY, "TEXT": {**TINY["TEXT"], **text}})
    cfg_path = tmp_path / "sent.yml"
    cfg_path.write_text(yaml.safe_dump({**TINY, "TEXT": {**TINY["TEXT"], **text}}))
    data = tmp_path / "data"
    data.mkdir()
    with open(data / "bert_captions.pickle", "wb") as f:
        pickle.dump([["a bird", "a b"], ["b"]], f)
    for split, cap in (("t", "a bird"), ("v", "a dog")):
        (tmp_path / f"{split}.jsonl").write_text(json.dumps({"image_id": split, "caption": cap}))

    def encode(**kw):
        embs, mask = te.make_hf_sbert_encode(cfg, **kw)(["a bird", "b"])
        assert embs.shape == (2, 6, 16) and np.isfinite(embs).all() and mask[0, :4].all()

    def build(**kw):
        te.build_sbert_cache(str(data), cfg, **kw)
        assert te.SbertCache(str(data), "train").rows([0, 1])[0].shape == (2, 6, 16)

    def sample(**kw):
        argv = ["sample", "--cfg", str(cfg_path), "--data_dir", str(data), "--caption", "a bird",
                "--n_per_caption", "1", "--out", str(tmp_path / "s.png"),
                "--output_root", str(tmp_path / "none")]
        assert cli.main(argv + [f"--device={kw['device']}"] if kw else argv) == 0

    def prep(**kw):
        argv = ["prep-ln", "--data_dir", str(tmp_path / "ln"), "--train_jsonl",
                str(tmp_path / "t.jsonl"), "--test_jsonl", str(tmp_path / "v.jsonl"),
                "--build_cache", "--cfg", str(cfg_path)]
        assert cli.main(argv + [f"--device={kw['device']}"] if kw else argv) == 0
        assert (tmp_path / "ln" / "sbert_cache_test.npz").is_file()

    call = {"make_hf_sbert_encode": encode, "build_sbert_cache": build, "cli sample": sample,
            "cli prep-ln --build_cache": prep}[entry]
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
        # under grad the CUDA path launches through the autograd Function (the
        # plain version is never taken), and a shape the backward's plan does
        # not take raises before any launch
        with pytest.raises(Reached):
            ca.masked_cross_attention_kernel(qc.clone().requires_grad_(), kc, kc, mc)
        wide_q, wide_k = torch.zeros(2, 3, 40), torch.zeros(2, 5, 40)
        with pytest.raises(ValueError, match="backward takes"):
            ca.masked_cross_attention_kernel(wide_q.requires_grad_(), wide_k, wide_k, mc)
    assert torch.Tensor.device is real_device
    before = ca.FORWARD.launches
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ca, "_launch", launch)
        ca.masked_cross_attention_kernel(qc, kc, kc, mc)
    assert ca.FORWARD.launches == before


OPERATORS = {  # case -> (module, its CUDA implementation, its plain version, eager wrapper)
    "fused_affine-single": (fa, "_fused_affine_cuda", "_ref", "modulate_lrelu_kernel"),
    "fused_affine-double": (fa, "_fused_affine_cuda", "_ref", "double_modulate_lrelu_kernel"),
    "masked_cross_attention": (ca, "_masked_cross_attention_cuda", "masked_cross_attention_ref",
                               "masked_cross_attention_kernel"),
}


def _operator_args(case: str):
    """(the operator's arguments, the eager wrapper's) for one case."""
    if case == "masked_cross_attention":
        q, k = torch.randn(2, 3, 4), torch.randn(2, 5, 4)
        mask = torch.tensor([[False] * 5, [False, True, True, True, True]])
        args = (q, k, k.flip(1), mask, 0.5)
        return args, args
    x = torch.randn(2, 8, 3, 5).contiguous(memory_format=torch.channels_last)
    vecs = [torch.randn(2, 8) for _ in range(2 if case.endswith("single") else 4)]
    return (x, vecs, 0.2), (x, *vecs, 0.2)


@pytest.mark.parametrize("case", sorted(OPERATORS))
def test_registered_operators_launch_on_cuda_and_run_the_plain_version_on_cpu(case):
    """Each registered operator (the node an exported program holds) has a
    CUDA and a CPU implementation and no decomposition.  The CUDA one
    reaches the launch and never the plain version; the CPU one is the
    plain version and launches nothing; the fake gives the launch's shape,
    dtype and strides."""
    module, cuda_impl, plain, wrapper = OPERATORS[case]
    name = case.split("-")[0]
    qualname = f"xmc_gan_tpu_torch::{name}"
    for key in ("CUDA", "CPU"):
        assert torch._C._dispatch_has_kernel_for_dispatch_key(qualname, key)
    assert not torch._C._dispatch_has_kernel_for_dispatch_key(qualname,
                                                             "CompositeImplicitAutograd")

    class Reached(Exception):
        pass

    def launch(*args):
        raise Reached

    args, eager_args = _operator_args(case)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module, "_launch", launch)
        mp.setattr(module, plain, lambda *a: pytest.fail("a CUDA call took the plain version"))
        with pytest.raises(Reached):
            getattr(module, cuda_impl)(*args)

    op = getattr(torch.ops.xmc_gan_tpu_torch, name)
    before = module.FORWARD.launches
    got = op(*args)
    assert module.FORWARD.launches == before
    assert torch.equal(got, getattr(module, wrapper)(*eager_args))  # the eager CPU path: plain

    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode() as mode:
        fake = op(*torch.utils._pytree.tree_map_only(torch.Tensor, mode.from_tensor, args))
    assert (fake.shape, fake.dtype, fake.stride()) == (got.shape, got.dtype, got.stride())
    if name == "fused_affine":  # what _launch allocates: empty_like(x)
        assert got.stride() == args[0].stride()


def test_modules_list_covers_the_slice():
    want = {"config", "device", "registry", "trainer", "train", "cli", "losses",
            "ops.initializers", "ops.modules", "ops.fused", "ops.images", "ops.cuda.build",
            "ops.cuda.fused_affine", "ops.cuda.damsm_score", "ops.cuda.cross_attention",
            "ops.cross_attention", "ops.grouped", "models.common", "models.df_gan",
            "models.df_concept_gan", "models.concept_gan", "models.encoder", "utils.convert",
            "utils.miscc", "data.vocab", "data.pipeline", "data.native", "data.toy",
            "utils.checkpoint", "utils.logger", "models.inception", "eval", "data.text_encode",
            "models.vgg", "utils.export", "data.coco_prep", "data.ln_prep", "data.bpe",
            "models.roberta"}
    assert {f"xmc_gan_tpu_torch.{m}" for m in want} <= set(MODULES)
    for name in MODULES:
        importlib.import_module(name)
