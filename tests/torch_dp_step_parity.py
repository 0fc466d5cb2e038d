"""One data-parallel train step (``train.make_train_step(cfg, mesh=...)``):
two gloo ranks on the CPU (``tests/torch_dp_workers.py``), each with its
contiguous two rows of a batch of 4 and of the JAX noise draw, take one fp32
step from the JAX package's perturbed state (carried across by
``utils/convert.train_state_from_jax``), at ``tests/torch_step_parity.py``'s
``_tiny`` sizes.  Held to:

* the JAX package's single-device step on the whole batch, with
  ``torch_step_parity``'s tolerances (metrics to 1e-4 relative; every
  parameter within 2 lr, 99.9% within lr / 20; the vectors to 1e-5);
* each other: the two ranks' parameters and vectors bit-equal, their metrics
  equal;
* the port's one-process step on the whole batch: metrics to 1e-5 relative;
  every parameter within 2 lr and 99.9% of each network's elements within
  1e-5.  The two sum the same gradients in another order, and an element
  whose gradient is zero in exact arithmetic (a conv bias ahead of the
  word-attention generators' BatchNorm) holds rounding noise in both, which
  Adam turns into a step of about +-lr either way.

``run_dp_step(name, workdir)`` runs one of ``CONFIGS``; the ``check_*``
functions hold it.  Configs (one test file each, so that ``--dist
loadfile`` spreads their JAX compiles): the flagship_word losses on
``df_gan_damsm.yml`` (WORD, B_GLOBAL, SPEC_NORM: the word scores as row
blocks, RMIS across the rank boundary, MAGP), a word-attention generator
(``concept_in_df_gan.yml`` with CONCEPT_INATTN_GEN: its BatchNorm over the
global batch, ``cross_attention``) and ``concept_out_df_gan.yml``
(CONCEPT_NETD, MAGP through it).
"""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from torch_dp_workers import Ranks
from torch_step_parity import (
    BS,
    CFG_DIR,
    EMB,
    NOISE,
    SIZE,
    T,
    TINY,
    WORD_LENS,
    _merge,
    _np,
    _perturb,
    _snapshot_jax,
    _snapshot_port,
    check_metrics,
    check_params,
    tiny_cfgs,
)
from xmc_gan_tpu import train as jax_train
from xmc_gan_tpu_torch import train
from xmc_gan_tpu_torch.utils import convert

WORLD = 2
SINGLE_RTOL, SINGLE_ATOL, SINGLE_SHARE = 1e-5, 1e-5, 0.999

# name: (yml, overrides, whether the batch carries words and mask)
CONFIGS = {
    "flagship_word": ("df_gan_damsm.yml",
                      {"TRAIN": {"ENCODER_LOSS": {"WORD": True, "B_GLOBAL": True}},
                       "DISC": {"SPEC_NORM": True}}, True),
    "word_attention": ("concept_in_df_gan.yml",
                       {"GEN": {"ENCODER_NAME": "CONCEPT_INATTN_GEN"}}, True),
    "concept_df": ("concept_out_df_gan.yml", {}, False),
    "word_attention_out": ("concept_in_df_gan.yml",
                           {"GEN": {"ENCODER_NAME": "CONCEPT_OUTATTN_GEN"}}, True),
    "concept_in_df": ("concept_in_df_gan.yml", {}, True),
}


def _prepare(name: str) -> dict:
    """The JAX state (perturbed weights, refreshed vectors), the same state in
    the port, the batch and the JAX noise draw of config ``name``."""
    yml, overrides, words = CONFIGS[name]
    jcfg, cfg = tiny_cfgs(yml, overrides)
    assert cfg.TRAIN.N_CRITIC == 1  # one step updates G
    state = jax.jit(functools.partial(jax_train.create_train_state, jcfg))(jax.random.PRNGKey(0))
    g = _perturb(_np(state.g_params), cfg.GEN.ENCODER_NAME, 1)
    d = _perturb(_np(state.d_params), cfg.DISC.ENCODER_NAME, 2)
    spec_v = _np(state.d_spectral)
    if spec_v:
        spec_v = _np(jax_train.refresh_spectral(d, spec_v, 20))
    g_tx, d_tx = jax_train.make_optimizers(jcfg)
    state = state.replace(g_params=g, d_params=d, d_spectral=spec_v,
                          g_opt_state=g_tx.init(g), d_opt_state=d_tx.init(d))
    port = convert.train_state_from_jax(cfg, g, d, spec_v, device="cpu")
    rng = np.random.RandomState(0)
    # the batch of torch_step_parity.run_step, so that the JAX step is the
    # program its tests compile (one compile where the cache holds it)
    batch = {"imgs": rng.randint(0, 256, (BS, SIZE, SIZE, 3)).astype(np.uint8),
             "sent_embs": rng.randn(BS, EMB).astype(np.float32)}
    if words:
        batch["words_embs"] = rng.randn(BS, T, EMB).astype(np.float32)
        batch["mask"] = np.arange(T)[None, :] >= np.array(WORD_LENS)[:, None]
    key = jax.random.PRNGKey(100)
    noise = np.asarray(jax.random.normal(key, (BS, NOISE), jnp.float32))  # the JAX draw
    return {"cfg": cfg, "jcfg": jcfg, "jax_state": state, "port": port,
            "init": _snapshot_port(port), "batch": batch, "noise": noise, "key": key,
            "spec": {"cfg": str(CFG_DIR / yml), "overrides": _merge(TINY, overrides)}}


def _spec(prep: dict) -> dict:
    return {**prep["spec"], "g": prep["init"]["g"], "d": prep["init"]["d"],
            "batches": [prep["batch"]], "noises": [prep["noise"]]}


def _single_and_jax(prep: dict) -> tuple[dict, dict]:
    """The port's one-process step and the JAX package's single-device step."""
    batch, noise = prep["batch"], prep["noise"]
    port = prep["port"]
    single = train.make_train_step(prep["cfg"])(port, batch, noise)
    state, jm = jax.jit(jax_train.make_train_step(prep["jcfg"]))(
        prep["jax_state"], {n: jnp.asarray(v) for n, v in batch.items()}, prep["key"])
    return ({"metrics": {n: float(v) for n, v in single.items()},
             "params": _snapshot_port(port)},
            {"metrics": {n: float(v) for n, v in jm.items()},
             "params": _snapshot_jax(prep["cfg"], state)})


def run_dp_step(name: str, workdir) -> dict:
    prep = _prepare(name)
    ranks = Ranks("step", workdir, WORLD, spec=_spec(prep))  # they run while JAX compiles
    single, jax_side = _single_and_jax(prep)
    ranks = ranks.join()
    cfg = prep["cfg"]
    return {"cfg": cfg, "ranks": ranks, "single": single,
            "dp_vs_jax": {"cfg": cfg, "steps": [
                {"jax": jax_side,
                 "port": {"metrics": ranks[0]["metrics"][0],
                          "params": {"g": ranks[0]["g"], "d": ranks[0]["d"]}}}]}}


def run_tp_step(name: str, workdir, meshes: tuple[tuple[int, int], ...], tp_min_size: int,
                with_jax: bool = True) -> dict:
    """``run_dp_step`` on ``dp x tp`` meshes (``job_tp_step``), all started
    at once: for each mesh its ranks, and the gathered state of rank 0 held
    as ``run_dp_step``'s; the JAX step only ``with_jax``."""
    prep = _prepare(name)
    spec = _spec(prep)
    started = {(dp, tp): Ranks("tp_step", Path(workdir) / f"dp{dp}_tp{tp}", dp * tp,
                               spec={**spec, "tp": tp, "tp_min_size": tp_min_size})
               for dp, tp in meshes}
    if with_jax:
        single, jax_side = _single_and_jax(prep)
    else:
        port = prep["port"]
        m = train.make_train_step(prep["cfg"])(port, prep["batch"], prep["noise"])
        single, jax_side = {"metrics": {n: float(v) for n, v in m.items()},
                            "params": _snapshot_port(port)}, None
    cfg = prep["cfg"]
    out = {"cfg": cfg, "single": single, "meshes": {}}
    for mesh, ranks in started.items():
        ranks = ranks.join()
        run = {"cfg": cfg, "ranks": ranks, "single": single}
        if jax_side is not None:
            run["dp_vs_jax"] = {"cfg": cfg, "steps": [
                {"jax": jax_side, "port": {"metrics": ranks[0]["metrics"][0],
                                           "params": {"g": ranks[0]["g"], "d": ranks[0]["d"]}}}]}
        out["meshes"][mesh] = run
    return out


def check_dp_vs_jax_metrics(run: dict) -> None:
    check_metrics(run["dp_vs_jax"])


def check_dp_vs_jax_params(run: dict) -> None:
    check_params(run["dp_vs_jax"])


def check_replicas_bit_equal(run: dict) -> None:
    a, *rest = run["ranks"]
    for b in rest:
        assert a["metrics"] == b["metrics"]
        for net in ("g", "d"):
            assert a[net].keys() == b[net].keys()
            for name, v in a[net].items():
                assert torch.equal(v, b[net][name]), (net, name)


def check_dp_vs_one_process(run: dict) -> None:
    got, want = run["ranks"][0], run["single"]
    assert got["metrics"][0].keys() == want["metrics"].keys()
    for name, w in want["metrics"].items():
        v = got["metrics"][0][name]
        assert abs(v - w) <= SINGLE_RTOL * abs(w) + 1e-7, (name, v, w)
    opt = run["cfg"].TRAIN.OPT
    for net, lr in (("g", opt.G_LR), ("d", opt.D_LR)):
        n_all = n_close = 0
        for name, w in want["params"][net].items():
            err = (got[net][name] - w).abs()
            assert err.max().item() <= 2 * lr, (net, name, err.max().item())
            n_all += err.numel()
            n_close += int((err <= SINGLE_ATOL).sum())
        assert n_close / n_all >= SINGLE_SHARE, (net, n_close, n_all)
