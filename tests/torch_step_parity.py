"""One fp32 train step of a shipped config, in the JAX package and in the
port, on the same perturbed weights (carried across by
``utils/convert.train_state_from_jax``), numpy batches and the JAX noise
draw, at the ``_tiny`` sizes of ``tests/test_integration_cfgs.py`` (NCH=8,
NEF=32, NOISE_DIM=16, batch 4, 64², EMBEDDING_DIM=48, MAX_LENGTH=6).

``run_step`` takes config overrides (e.g. a word-attention generator as
``GEN.ENCODER_NAME``, or ``ENCODER_LOSS.VGG``), a batch with ``words_embs``
and ``mask`` (every caption with a real word: the JAX chain gives NaN for
one without), and, with VGG on, the same random VGG-19 in both packages
(the JAX ``VGG19Features`` init, carried across by
``utils/convert.vgg_state_dict_from_jax``).

With ``N_CRITIC`` = 2 a second step runs, alone, from the JAX state after
the first (its parameters, power-iteration vectors and Adam moments carried
across), so that the step which updates G is held to JAX as closely as the
first.  Tolerances, as ``tests/test_torch_train_step.py`` states them:
metrics to 1e-4 relative (the losses summed in another order); 99.9% of
each network's elements within lr / 20 and every element within 2 lr (Adam
moves an element whose gradient is near 0 by about +-lr either way); the
vectors to 1e-5.
"""

from __future__ import annotations

import dataclasses
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from torch_port_helpers import perturb, perturb_concept
from xmc_gan_tpu import train as jax_train
from xmc_gan_tpu.config import cfg_from_file as jax_cfg_from_file
from xmc_gan_tpu.models.vgg import VGG19Features as JaxVGG
from xmc_gan_tpu_torch import train
from xmc_gan_tpu_torch.config import cfg_from_dict, cfg_from_file
from xmc_gan_tpu_torch.models.vgg import VGG19Features
from xmc_gan_tpu_torch.utils import convert

CFG_DIR = Path(__file__).resolve().parents[1] / "xmc_gan_tpu" / "cfg"
BS, SIZE, EMB, T, NOISE = 4, 64, 48, 6, 16
TINY = {"TRAIN": {"NCH": 8, "NEF": 32, "NOISE_DIM": NOISE, "BATCH_SIZE": BS, "HE_INIT": True},
        "IMG": {"SIZE": SIZE}, "TEXT": {"EMBEDDING_DIM": EMB, "MAX_LENGTH": T}}
METRIC_RTOL, METRIC_ATOL = 1e-4, 1e-7
CLOSE_SHARE, CLOSE_LR_FRAC = 0.999, 0.05
UV_ATOL = 1e-5


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for key, val in over.items():
        out[key] = _merge(out.get(key, {}), val) if isinstance(val, dict) else val
    return out


def _jax_replace(node, over: dict):
    """A JAX-package config (frozen dataclasses) with nested ``over`` applied."""
    return dataclasses.replace(node, **{
        key: _jax_replace(getattr(node, key), val) if isinstance(val, dict) else val
        for key, val in over.items()})


def tiny_cfgs(name: str, overrides: dict | None = None):
    """``xmc_gan_tpu/cfg/<name>`` at the ``_tiny`` sizes with ``overrides``,
    as a JAX-package and a port config (every other switch of the file
    kept)."""
    jcfg = jax_cfg_from_file(str(CFG_DIR / name))
    jcfg = jcfg.replace(
        TRAIN=dataclasses.replace(jcfg.TRAIN, **TINY["TRAIN"]),
        IMG=jcfg.IMG.__class__(SIZE=SIZE),
        TEXT=dataclasses.replace(jcfg.TEXT, EMBEDDING_DIM=EMB, MAX_LENGTH=T))
    if overrides:
        jcfg = _jax_replace(jcfg, overrides)
    return jcfg, cfg_from_dict(_merge(TINY, overrides or {}),
                               base=cfg_from_file(str(CFG_DIR / name)))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _trees(cfg):
    g = convert._G_TREES[cfg.GEN.ENCODER_NAME or "DF_GEN"]
    d = convert._D_TREES[cfg.DISC.ENCODER_NAME or "DF_DISC"]
    return g, d


def _perturb(tree, name: str, seed: int):
    return (perturb if name in ("DF_GEN", "DF_DISC") else perturb_concept)(tree, seed)


def _snapshot_jax(cfg, state):
    g_tree, d_tree = _trees(cfg)
    return {"g": g_tree(_np(state.g_params)),
            "d": d_tree(_np(state.d_params), _np(state.d_spectral))}


def _snapshot_port(state):
    return {"g": {k: v.clone() for k, v in state.g.state_dict().items()},
            "d": {k: v.clone() for k, v in state.d.state_dict().items()}}


def _port_from_jax(cfg, state, step: int):
    """The JAX ``state`` as a port state on the CPU, its Adam moments too."""
    port = convert.train_state_from_jax(cfg, _np(state.g_params), _np(state.d_params),
                                        _np(state.d_spectral), step=step, device="cpu")
    g_tree, d_tree = _trees(cfg)
    for net, opt, jopt, conv in ((port.g, port.g_opt, state.g_opt_state, g_tree),
                                 (port.d, port.d_opt, state.d_opt_state, d_tree)):
        adam = jopt[0]
        mu, nu, count = conv(_np(adam.mu)), conv(_np(adam.nu)), float(adam.count)
        for name, p in net.named_parameters():
            opt.state[p] = {"step": torch.tensor(count), "exp_avg": mu[name].clone(),
                            "exp_avg_sq": nu[name].clone()}
    return port


# caption lengths of the batch's words (every caption with a real word)
WORD_LENS = [T, 1, 3, 5]


def run_step(name: str, overrides: dict | None = None, words: bool = False) -> dict:
    """The first step free-running from the perturbed state and, with
    ``N_CRITIC`` = 2, the second step alone from the JAX state after the
    first; ``words``: the batch carries ``words_embs`` and ``mask``
    (``WORD_LENS``).  Returns the config and, per step, both packages'
    metrics and parameters."""
    jcfg, cfg = tiny_cfgs(name, overrides)
    state = jax.jit(functools.partial(jax_train.create_train_state, jcfg))(jax.random.PRNGKey(0))
    g = _perturb(_np(state.g_params), cfg.GEN.ENCODER_NAME, 1)
    d = _perturb(_np(state.d_params), cfg.DISC.ENCODER_NAME, 2)
    spec = _np(state.d_spectral)
    if spec:  # vectors near the top singular ones: sigma near each kernel's norm
        spec = _np(jax_train.refresh_spectral(d, spec, 20))
    g_tx, d_tx = jax_train.make_optimizers(jcfg)
    state = state.replace(g_params=g, d_params=d, d_spectral=spec,
                          g_opt_state=g_tx.init(g), d_opt_state=d_tx.init(d))
    jstep = jax.jit(jax_train.make_train_step(jcfg))
    pstep = train.make_train_step(cfg)
    port = convert.train_state_from_jax(cfg, g, d, spec, device="cpu")
    jvgg = pvgg = None
    if cfg.TRAIN.ENCODER_LOSS.VGG:
        jvgg = _np(JaxVGG().init(jax.random.PRNGKey(19), jnp.zeros((1, SIZE, SIZE, 3))))
        pvgg = VGG19Features()
        pvgg.load_state_dict(convert.vgg_state_dict_from_jax(jvgg), strict=True)
    rng = np.random.RandomState(0)
    steps = []
    for k in range(cfg.TRAIN.N_CRITIC):
        batch = {"imgs": rng.randint(0, 256, (BS, SIZE, SIZE, 3)).astype(np.uint8),
                 "sent_embs": rng.randn(BS, EMB).astype(np.float32)}
        if words:
            batch["words_embs"] = rng.randn(BS, T, EMB).astype(np.float32)
            batch["mask"] = np.arange(T)[None, :] >= np.array(WORD_LENS)[:, None]
        key = jax.random.PRNGKey(100 + k)
        noise = np.asarray(jax.random.normal(key, (BS, NOISE), jnp.float32))  # the JAX draw
        if k > 0:
            port = _port_from_jax(cfg, state, k)
        pm = pstep(port, batch, noise, pvgg)
        state, jm = jstep(state, {n: jnp.asarray(v) for n, v in batch.items()}, key, jvgg)
        steps.append({"jax": {"metrics": {n: float(v) for n, v in jm.items()},
                              "params": _snapshot_jax(cfg, state)},
                      "port": {"metrics": {n: float(v) for n, v in pm.items()},
                               "params": _snapshot_port(port)}})
    return {"cfg": cfg, "steps": steps}


def check_metrics(run: dict) -> None:
    for k, s in enumerate(run["steps"]):
        j, p = s["jax"]["metrics"], s["port"]["metrics"]
        assert set(p) == set(j), k
        for name, want in j.items():
            got = p[name]
            assert abs(got - want) <= METRIC_RTOL * abs(want) + METRIC_ATOL, (k, name, got, want)


def check_params(run: dict) -> None:
    """Every step's G and D parameters and D's vectors (see the module
    docstring for the bounds); G moves on the steps that update it."""
    opt, n_critic = run["cfg"].TRAIN.OPT, run["cfg"].TRAIN.N_CRITIC
    for k, s in enumerate(run["steps"]):
        want, got = s["jax"]["params"], s["port"]["params"]
        for net, lr in (("g", opt.G_LR), ("d", opt.D_LR)):
            assert set(got[net]) == set(want[net])
            n_all = n_close = 0
            for name, w in want[net].items():
                err = (got[net][name] - w).abs()
                if name.endswith(("weight_u", "weight_v")):
                    assert err.max().item() <= UV_ATOL, name
                    continue
                assert err.max().item() <= 2 * lr, (k, net, name)
                n_all += err.numel()
                n_close += int((err <= CLOSE_LR_FRAC * lr).sum())
            assert n_close / n_all >= CLOSE_SHARE, (k, net, n_close, n_all)
        assert s["jax"]["metrics"]["g_updated"] == float((k + 1) % n_critic == 0)
