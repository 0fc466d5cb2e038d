"""The port's weight converters and the CLI's ``convert-fid-weights``,
``convert-vgg-weights`` and ``export-sampler`` against the JAX CLI's.

Seeded random torchvision-named Inception-v3 and VGG-19 state_dicts (with
the tensors a converter drops: ``AuxLogits``, ``num_batches_tracked``, VGG's
classifier) are saved as ``.pth``; both CLIs convert them, and the two
``.npz`` hold the same keys in the same order with bit-equal arrays.  The
port then loads its ``.npz`` to the features it gets from the ``.pth``
(exact: the same fp32 values reach the same modules).  ``export-sampler``:
both CLIs export a tiny config with a symbolic batch; the two artifacts serve
the same seeded parameters and inputs to images within 5e-5 (fp32, the
generators' parity tolerance)."""

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from torch_port_helpers import one_torch_thread  # noqa: F401  (fixture)
from torch_port_helpers import perturb
from xmc_gan_tpu import cli as jcli
from xmc_gan_tpu.config import cfg_from_file as jax_cfg_from_file
from xmc_gan_tpu.models.df_gan import NetG as JaxNetG
from xmc_gan_tpu.utils import export as jexport
from xmc_gan_tpu_torch import cli
from xmc_gan_tpu_torch.eval import FidComputer, load_fid_weights_npz, save_fid_weights_npz
from xmc_gan_tpu_torch.models.inception import InceptionV3, inception_params_from_torch
from xmc_gan_tpu_torch.models.vgg import VGG19Features, make_vgg, vgg19_params_from_torch
from xmc_gan_tpu_torch.utils import export as pexport
from xmc_gan_tpu_torch.utils.convert import df_gan_generator_state_dict


def _random_state_dict(names: dict, seed: int) -> dict:
    """Seeded values for every tensor: weights ~ N(0, 1/fan_in), BN scales
    and running variances ~ U(0.5, 1.5), other floats ~ N(0, 0.1^2)."""
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in names.items():
        shape = tuple(v.shape)
        if not v.is_floating_point():
            out[k] = torch.tensor(7)
        elif k.endswith("running_var") or (k.endswith("bn.weight")):
            out[k] = torch.from_numpy(rng.uniform(0.5, 1.5, shape).astype(np.float32))
        elif k.endswith("weight") and len(shape) > 1:
            fan_in = int(np.prod(shape[1:]))
            out[k] = torch.from_numpy((rng.standard_normal(shape) / np.sqrt(fan_in))
                                      .astype(np.float32))
        else:
            out[k] = torch.from_numpy((0.1 * rng.standard_normal(shape)).astype(np.float32))
    return out


def _convert_both(tmp_path, kind: str, sd: dict):
    """Save ``sd`` as ``.pth``, run both CLIs' ``convert-{kind}-weights`` on
    it, and return the two ``.npz`` paths."""
    src, jout, pout = (str(tmp_path / n) for n in ("w.pth", "jax.npz", "port.npz"))
    torch.save(sd, src)
    runner = {"fid": jcli.run_convert_fid_weights, "vgg": jcli.run_convert_vgg_weights}[kind]
    runner(argparse.Namespace(src=src, out=jout))
    assert cli.main([f"convert-{kind}-weights", "--src", src, "--out", pout]) == 0
    with np.load(jout) as want, np.load(pout) as got:
        assert got.files == want.files
        for name in want.files:
            assert got[name].dtype == want[name].dtype == np.float32, name
            np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    return src, pout


def test_convert_fid_weights_matches_jax_and_loads(tmp_path, one_torch_thread):
    names = InceptionV3(num_classes=1000).state_dict()
    names["AuxLogits.conv0.conv.weight"] = torch.zeros(128, 768, 1, 1)
    names["AuxLogits.fc.weight"] = torch.zeros(1000, 768)
    src, npz = _convert_both(tmp_path, "fid", _random_state_dict(names, 0))
    tree = load_fid_weights_npz(npz)
    assert set(tree) == {"params", "batch_stats"} and "AuxLogits" not in tree["params"]
    images = np.random.RandomState(1).randint(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    want = FidComputer(weights_path=src, device="cpu").features(images)
    got = FidComputer(weights_path=npz, device="cpu").features(images)
    assert got.shape == (2, 2048) and bool(torch.isfinite(got).all())
    assert torch.equal(got, want)


def test_convert_vgg_weights_matches_jax_and_loads(tmp_path, one_torch_thread):
    names = dict(VGG19Features().state_dict())
    names["classifier.0.weight"] = torch.zeros(16, 32)
    names["classifier.0.bias"] = torch.zeros(16)
    src, npz = _convert_both(tmp_path, "vgg", _random_state_dict(names, 2))
    assert sorted(load_fid_weights_npz(npz)["params"]) == sorted(f"conv{i}" for i in range(16))
    x = torch.from_numpy(np.random.RandomState(3).uniform(-1, 1, (2, 3, 32, 32))
                         .astype(np.float32))
    want = make_vgg(device="cpu", path=src)(x)
    got = make_vgg(device="cpu", path=npz)(x)
    assert got.shape == (2, 512) and torch.equal(got, want)


def test_converters_take_arrays_and_refuse_unknown_tensors(tmp_path):
    """The converters read numpy arrays as they read tensors; an Inception
    tensor name they do not know raises, as in the JAX package."""
    sd = {"Conv2d_1a_3x3.conv.weight": np.ones((32, 3, 3, 3), np.float16),
          "Conv2d_1a_3x3.bn.running_var": torch.full((32,), 2.0)}
    tree = inception_params_from_torch(sd)
    assert tree["params"]["Conv2d_1a_3x3"]["conv"]["kernel"].shape == (3, 3, 3, 32)
    assert tree["batch_stats"]["Conv2d_1a_3x3"]["bn"]["var"].dtype == np.float32
    with pytest.raises(KeyError, match="Unrecognized inception tensor"):
        inception_params_from_torch({"Mixed_5b.branch1x1.weird": torch.zeros(2)})
    vgg = vgg19_params_from_torch({"module.features.2.weight": np.ones((4, 4, 3, 3)),
                                   "module.features.2.bias": np.zeros(4),
                                   "module.features.0.weight": torch.ones(4, 3, 3, 3),
                                   "module.features.0.bias": torch.zeros(4)})
    assert list(vgg["params"]) == ["conv0", "conv1"]
    save_fid_weights_npz(vgg, str(tmp_path / "v.npz"))
    with np.load(tmp_path / "v.npz") as f:
        assert f.files == ["params/conv0/bias", "params/conv0/kernel", "params/conv1/bias",
                           "params/conv1/kernel"]


TINY = {"CONFIG_NAME": "TINY_EXPORT",
        "TRAIN": {"NCH": 8, "NEF": 32, "NOISE_DIM": 16, "HE_INIT": True},
        "IMG": {"SIZE": 128}, "TEXT": {"EMBEDDING_DIM": 48, "MAX_LENGTH": 8}}


def test_cli_export_sampler_matches_the_jax_cli(tmp_path, capsys):
    """Both CLIs' ``export-sampler`` on one YAML (``--imsize 64`` overrides
    its 128): the artifacts serve the same parameters and inputs alike at
    two batch sizes; ``--bs 2`` pins the port's batch."""
    yml = tmp_path / "tiny.yml"
    yml.write_text(yaml.safe_dump(TINY))
    jpath, ppath, pinned = (str(tmp_path / n) for n in ("s.jaxexport", "s.pt2", "s2.pt2"))
    assert jcli.main(["export-sampler", "--cfg", str(yml), "--out", jpath, "--imsize", "64",
                      "--platforms", "cpu"]) == 0
    assert cli.main(["export-sampler", "--cfg", str(yml), "--out", ppath, "--imsize", "64",
                     "--device", "cpu"]) == 0
    assert cli.main(["export-sampler", "--cfg", str(yml), "--out", pinned, "--imsize", "64",
                     "--device", "cpu", "--bs", "2"]) == 0
    assert capsys.readouterr().out.split() == [jpath, ppath, pinned]

    jcfg = jax_cfg_from_file(str(yml))
    jcfg = jcfg.replace(IMG=dataclasses.replace(jcfg.IMG, SIZE=64))
    shapes = jax.eval_shape(JaxNetG(jcfg).init, jax.random.PRNGKey(0), jnp.zeros((1, 16)),
                            jnp.zeros((1, 48)))
    params = perturb(shapes["params"], 3)
    sd = df_gan_generator_state_dict(params)
    jserve, pserve = jexport.load_sampler(jpath), pexport.load_sampler(ppath)
    rng = np.random.RandomState(4)
    for b in (2, 3):
        noise = rng.randn(b, 16).astype(np.float32)
        sent = rng.randn(b, 48).astype(np.float32)
        want = np.asarray(jserve(params, noise, sent))
        got = pserve(sd, noise, sent)
        assert got.shape == want.shape == (b, 64, 64, 3)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-5)
        if b == 2:
            assert torch.equal(pexport.load_sampler(pinned)(sd, noise, sent), got)
