"""The port's train step against the JAX package's ``make_train_step``: one
JAX train state (perturbed weights) carried across by
``utils/convert.train_state_from_jax``, the same numpy batches and the JAX
noise draw, fp32, three steps.  Every metric, every updated G/D parameter
and D's power-iteration vectors are compared after the first and the third
step, and the first step's gradients through the Adam moments they leave.

Two configurations, each built once (module-scoped fixtures):
``word``, the flagship_word step's losses (SENT, DISC, WORD, B_GLOBAL, RMIS,
MAGP, spectral norm) with N_CRITIC = 2, so G updates on the second step only;
and ``sent``, the same without WORD at N_CRITIC = 1.  NCH=4, 64², batch 4.

Tolerances.  The losses are the same expressions summed in another order
(XLA's and PyTorch's CPU kernels): metrics to 2e-5 relative.  Adam (beta1 =
0.5) moves a parameter by about +-lr per step whatever its gradient's size,
so an element whose gradient is near 0 (|g| ~ eps = 1e-8, e.g. where it
nearly cancels) can take the other sign and land up to 2 lr per step away;
every element is held to that.  After one step 99.9% of each network's
elements are held to lr / 20.  Over three free-running steps those few
eps-scale differences feed the next steps' gradients, and where Adam's
first moment cancels between steps its update is sensitive to them: after
three steps 95% of the elements are held to lr / 20 (98.4% measured for G in
``sent``).  So each later step is also run alone from the JAX state before
it (parameters, vectors and Adam moments carried across), where 99.9% are
held to lr / 20 again.  The vectors to 1e-5.  The moments after the first
step are fixed linear (mu) and quadratic (nu) functions of that step's
gradients: each tensor to 1e-3 of its largest magnitude (a gate's gradient
is one sum over a whole activation, where fp32 cancellation leaves ~1e-4
relative).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import perturb, small_cfgs
from xmc_gan_tpu import train as jax_train
from xmc_gan_tpu_torch import train
from xmc_gan_tpu_torch.utils.convert import (
    df_gan_discriminator_state_dict,
    df_gan_generator_state_dict,
    train_state_from_jax,
)

BS, SIZE, EMB, T, NOISE = 4, 64, 16, 6, 8
STEPS = 3
METRIC_RTOL, METRIC_ATOL = 2e-5, 1e-7
CLOSE_SHARE, CLOSE_SHARE_FREE, CLOSE_LR_FRAC = 0.999, 0.95, 0.05
UV_ATOL = 1e-5
MOMENT_SCALE = 1e-3


def _overrides(word: bool) -> dict:
    return {
        "TRAIN": {"NCH": 4, "NEF": 16, "NOISE_DIM": NOISE, "HE_INIT": True, "RMIS_LOSS": True,
                  "MAGP": True, "N_CRITIC": 2 if word else 1,
                  "ENCODER_LOSS": {"SENT": True, "DISC": True, "B_GLOBAL": True, "WORD": word},
                  "SMOOTH": {"GLOBAL": 0.0}},
        "IMG": {"SIZE": SIZE}, "TEXT": {"EMBEDDING_DIM": EMB, "MAX_LENGTH": T},
        "DISC": {"SPEC_NORM": True, "IMG_MATCH": True},
    }


def _batches(word: bool):
    rng = np.random.RandomState(0)
    out = []
    for _ in range(STEPS):
        b = {"imgs": rng.randint(0, 256, (BS, SIZE, SIZE, 3)).astype(np.uint8),
             "sent_embs": rng.randn(BS, EMB).astype(np.float32)}
        if word:
            lens = rng.randint(1, T + 1, BS)
            b["words_embs"] = rng.randn(BS, T, EMB).astype(np.float32)
            b["mask"] = np.arange(T)[None, :] >= lens[:, None]
        out.append(b)
    return out


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _snapshot_jax(state):
    d = df_gan_discriminator_state_dict(_np(state.d_params), _np(state.d_spectral))
    return {"g": df_gan_generator_state_dict(_np(state.g_params)), "d": d}


def _snapshot_port(state):
    return {"g": {k: v.clone() for k, v in state.g.state_dict().items()},
            "d": {k: v.clone() for k, v in state.d.state_dict().items()}}


def _moments_port(state):
    out = {}
    for net, opt, key in ((state.g, state.g_opt, "g"), (state.d, state.d_opt, "d")):
        for name, p in net.named_parameters():
            if p in opt.state:
                out[(key, name)] = (opt.state[p]["exp_avg"].clone(),
                                    opt.state[p]["exp_avg_sq"].clone())
    return out


def _moments_jax(state):
    out = {}
    for key, opt, conv in (("g", state.g_opt_state, df_gan_generator_state_dict),
                           ("d", state.d_opt_state, df_gan_discriminator_state_dict)):
        adam = opt[0]
        mu, nu = conv(_np(adam.mu)), conv(_np(adam.nu))
        for name in mu:
            out[(key, name)] = (mu[name], nu[name])
    return out


def _with_jax_moments(port, state):
    """``port`` with the Adam moments and step counts of the JAX ``state``."""
    for net, opt, jopt, conv in ((port.g, port.g_opt, state.g_opt_state,
                                  df_gan_generator_state_dict),
                                 (port.d, port.d_opt, state.d_opt_state,
                                  df_gan_discriminator_state_dict)):
        adam = jopt[0]
        mu, nu, count = conv(_np(adam.mu)), conv(_np(adam.nu)), float(adam.count)
        for name, p in net.named_parameters():
            opt.state[p] = {"step": torch.tensor(count), "exp_avg": mu[name].clone(),
                            "exp_avg_sq": nu[name].clone()}
    return port


def _run(word: bool) -> dict:
    jcfg, cfg = small_cfgs(_overrides(word))
    state = jax.jit(functools.partial(jax_train.create_train_state, jcfg))(jax.random.PRNGKey(0))
    g = perturb(_np(state.g_params), 1)
    d = perturb(_np(state.d_params), 2)
    # vectors near the top singular ones: sigma near each kernel's norm
    spec = _np(jax_train.refresh_spectral(d, _np(state.d_spectral), 20))
    g_tx, d_tx = jax_train.make_optimizers(jcfg)
    state = state.replace(g_params=g, d_params=d, d_spectral=spec,
                          g_opt_state=g_tx.init(g), d_opt_state=d_tx.init(d))
    jstep = jax.jit(jax_train.make_train_step(jcfg))
    port = train_state_from_jax(cfg, g, d, spec, device="cpu")
    pstep = train.make_train_step(cfg)
    rec = {"cfg": cfg, "jax": [], "port": [], "forced": []}
    for k, batch in enumerate(_batches(word)):
        key = jax.random.PRNGKey(100 + k)
        noise = np.asarray(jax.random.normal(key, (BS, NOISE), jnp.float32))  # the JAX draw
        if k > 0:  # this step alone, from the JAX state before it
            forced = _with_jax_moments(train_state_from_jax(
                cfg, _np(state.g_params), _np(state.d_params), _np(state.d_spectral),
                step=k, device="cpu"), state)
            pstep(forced, batch, noise)
        state, jm = jstep(state, {n: jnp.asarray(v) for n, v in batch.items()}, key)
        pm = pstep(port, batch, noise)
        if k > 0:
            rec["forced"].append({"jax": _snapshot_jax(state), "port": _snapshot_port(forced)})
        rec["jax"].append({"metrics": {n: float(v) for n, v in jm.items()},
                           "params": _snapshot_jax(state)})
        rec["port"].append({"metrics": {n: float(v) for n, v in pm.items()},
                            "params": _snapshot_port(port)})
        if k == 0:
            rec["jax"][0]["moments"] = _moments_jax(state)
            rec["port"][0]["moments"] = _moments_port(port)
    return rec


@pytest.fixture(scope="module", params=["word", "sent"])
def run(request):
    return _run(request.param == "word")


def test_metrics_match_jax(run):
    for k, (j, p) in enumerate(zip(run["jax"], run["port"])):
        assert set(p["metrics"]) == set(j["metrics"]), k
        for name, want in j["metrics"].items():
            got = p["metrics"][name]
            assert abs(got - want) <= METRIC_RTOL * abs(want) + METRIC_ATOL, (k, name, got, want)


def _check_params(opt, want, got, steps, share):
    for net, lr in (("g", opt.G_LR), ("d", opt.D_LR)):
        assert set(got[net]) == set(want[net])
        n_all = n_close = 0
        for name, w in want[net].items():
            err = (got[net][name] - w).abs()
            if name.endswith(("weight_u", "weight_v")):
                assert err.max().item() <= UV_ATOL, name
                continue
            assert err.max().item() <= 2 * lr * steps, name
            n_all += err.numel()
            n_close += int((err <= CLOSE_LR_FRAC * lr).sum())
        assert n_close / n_all >= share, (net, n_close, n_all)


@pytest.mark.parametrize("after", [1, STEPS])
def test_params_and_vectors_match_jax(run, after):
    """Free-running from the first state: after one and three steps."""
    _check_params(run["cfg"].TRAIN.OPT, run["jax"][after - 1]["params"],
                  run["port"][after - 1]["params"], after,
                  CLOSE_SHARE if after == 1 else CLOSE_SHARE_FREE)


@pytest.mark.parametrize("k", [1, 2])
def test_later_step_from_the_jax_state_matches_jax(run, k):
    """Step k + 1 alone, from the JAX state after step k (its parameters,
    vectors and Adam moments): Adam's later steps and the step counter."""
    forced = run["forced"][k - 1]
    _check_params(run["cfg"].TRAIN.OPT, forced["jax"], forced["port"], 1, CLOSE_SHARE)


def test_first_step_gradients_match_jax(run):
    """Through the Adam moments of the first step: G's is one Adam update
    (mu = (1 - beta1) g), D's the D-loss update then the MAGP update."""
    j, p = run["jax"][0]["moments"], run["port"][0]["moments"]
    g_updated = run["jax"][0]["metrics"]["g_updated"] == 1.0
    want_keys = {k for k in j if k[0] == "d" or g_updated}
    assert set(p) == want_keys
    for key in want_keys:
        for got, want in zip(p[key], j[key]):
            scale = want.abs().max().item()
            torch.testing.assert_close(got, want, rtol=0, atol=MOMENT_SCALE * scale + 1e-30,
                                       msg=str(key))


def test_g_updates_every_n_critic_steps(run):
    """N_CRITIC = 2 (``word``): the first step leaves G as it was and reports
    ``g_updated`` 0 and zero G losses; the second updates it.  N_CRITIC = 1
    (``sent``): every step updates G."""
    n_critic = run["cfg"].TRAIN.N_CRITIC
    for k, (j, p) in enumerate(zip(run["jax"], run["port"])):
        want = float((k + 1) % n_critic == 0)
        assert p["metrics"]["g_updated"] == j["metrics"]["g_updated"] == want
        if not want:
            assert p["metrics"]["Loss_G"] == p["metrics"]["gs_loss"] == 0.0
    if n_critic == 2:
        g0, g1 = run["port"][0]["params"]["g"], run["port"][1]["params"]["g"]
        assert "moments" in run["port"][0] and not any(k[0] == "g" for k in
                                                       run["port"][0]["moments"])
        assert any(not torch.equal(g0[n], g1[n]) for n in g0)


def test_optimizers_follow_the_config():
    _, cfg = small_cfgs(_overrides(False))
    state = train.create_train_state(cfg, device="cpu")
    opt = cfg.TRAIN.OPT
    for o, lr, betas in ((state.g_opt, opt.G_LR, (opt.G_BETA1, opt.G_BETA2)),
                         (state.d_opt, opt.D_LR, (opt.D_BETA1, opt.D_BETA2))):
        group = o.param_groups[0]
        assert (group["lr"], group["betas"], group["eps"], group["weight_decay"]) == (
            lr, betas, 1e-8, 0)
    assert state.step == 0 and state.g.training and state.d.training
