"""The port's tensor-parallel layout (``parallel.state_shardings``) against the
JAX package's ``state_shardings(make_mesh(dp, tp), state, tp_min_size)`` on
the same configuration, from shapes alone (``jax.eval_shape`` there, the
``meta`` device here): on meshes (2, 2) and (4, 2), the tiny
flagship_word and ``concept_out_df_gan.yml`` configurations of the step
tests at ``tp_min_size = 1 << 12`` and ``ln_coco_256.yml`` at full width at
the default ``1 << 16``.

Each JAX leaf of G's and D's parameters and of D's spectral tree is carried
to its port name through ``utils/convert``'s maps (the converters run on
one-element stand-ins, so no weight is made).  The same leaves must be split
(``RowShard``) or replicated (``None``) on both sides, and the JAX Adam
moments must follow their parameters, as the port's do by construction
(``tests/test_torch_tp_step.py`` checks their shapes on the ranks).  At the
tiny sizes the axis is checked too: each JAX leaf is filled with its
trailing (output-feature) index, converted, and the rows that
``RowShard.take`` gives model rank m must hold exactly the indices
``[m*n/tp, (m+1)*n/tp)`` of that axis, as JAX's ``P(..., 'model')`` gives
it.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from torch_step_parity import _trees, tiny_cfgs
from xmc_gan_tpu import train as jax_train
from xmc_gan_tpu.config import cfg_from_file as jax_cfg_from_file
from xmc_gan_tpu.parallel import make_mesh, state_shardings as jax_state_shardings
from xmc_gan_tpu_torch.config import cfg_from_file
from xmc_gan_tpu_torch.parallel import state_shardings
from xmc_gan_tpu_torch.parallel.tensor import RowShard
from xmc_gan_tpu_torch.train import make_models

CFG_DIR = "xmc_gan_tpu/cfg"
FLAGSHIP_WORD = {"TRAIN": {"ENCODER_LOSS": {"WORD": True, "B_GLOBAL": True}},
                 "DISC": {"SPEC_NORM": True}}
MESHES = ((2, 2), (4, 2))


def _configs():
    """name -> (JAX config, port config, tp_min_size, check the axis by value)."""
    out = {}
    for name, yml, over in (("flagship_word", "df_gan_damsm.yml", FLAGSHIP_WORD),
                            ("concept_df", "concept_out_df_gan.yml", {})):
        jcfg, cfg = tiny_cfgs(yml, over)
        out[name] = (jcfg, cfg, 1 << 12, True)
    ln = f"{CFG_DIR}/ln_coco_256.yml"
    out["ln_coco_256"] = (jax_cfg_from_file(ln), cfg_from_file(ln), 1 << 16, False)
    return out


CONFIGS = _configs()


@functools.lru_cache(maxsize=None)
def _jax_state(name):
    return jax.eval_shape(functools.partial(jax_train.create_train_state, CONFIGS[name][0]),
                          jax.random.PRNGKey(0))


def _is_split(sharding) -> bool:
    spec = tuple(sharding.spec)
    assert all(a is None for a in spec[:-1])  # only ever the trailing axis
    return bool(spec) and spec[-1] == "model"


def _port_names(cfg, g_tree, d_tree, spectral, fill):
    """Each JAX leaf's port ``state_dict`` entries: the trees filled by
    ``fill(path, leaf)`` and converted; returns (G's, D's) name -> tensor."""
    def filled(tree):
        return jax.tree_util.tree_map_with_path(fill, tree)

    g_conv, d_conv = _trees(cfg)
    return g_conv(filled(g_tree)), d_conv(filled(d_tree), filled(spectral))


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"dp{m[0]}_tp{m[1]}")
@pytest.mark.parametrize("name", CONFIGS)
def test_state_shardings_match_jax(name, mesh, eight_devices):
    jcfg, cfg, min_size, by_value = CONFIGS[name]
    dp, tp = mesh
    state = _jax_state(name)
    shard = jax_state_shardings(make_mesh(dp=dp, tp=tp), state, min_size)
    # the Adam moments follow their parameters in JAX
    for params, opt in ((shard.g_params, shard.g_opt_state), (shard.d_params, shard.d_opt_state)):
        adam = opt[0]
        for tree in (adam.mu, adam.nu):
            assert jax.tree.map(_is_split, tree) == jax.tree.map(_is_split, params)
    assert not _is_split(shard.step)

    # JAX leaf id -> (path, shape); each port name -> its leaf id (a one-element stand-in)
    leaves = {}

    def leaf_id(path, leaf):
        leaves[len(leaves)] = (path, leaf.shape)
        return np.full((1,) * len(leaf.shape), len(leaves) - 1, np.float32)

    trees = (state.g_params, state.d_params, state.d_spectral)
    g_ids, d_ids = _port_names(cfg, *trees, leaf_id)
    split_of = {}
    for tree, sh in zip(trees, (shard.g_params, shard.d_params, shard.d_spectral)):
        for (path, _), s in zip(jax.tree_util.tree_leaves_with_path(tree), jax.tree.leaves(sh)):
            split_of[jax.tree_util.keystr(path)] = _is_split(s)

    with torch.device("meta"):
        g, d = make_models(cfg)
    port = state_shardings(tp, torch.nn.ModuleDict({"g": g, "d": d}), min_size)
    n_split = 0
    for net, ids in (("g", g_ids), ("d", d_ids)):
        assert {k.removeprefix(f"{net}.") for k in port if k.startswith(f"{net}.")} == set(ids)
        for pname, t in ids.items():
            path, shape = leaves[int(t.reshape(-1)[0])]
            want = split_of[jax.tree_util.keystr(path)]
            got = port[f"{net}.{pname}"]
            assert (got is not None) == want, (net, pname, jax.tree_util.keystr(path), shape)
            if got is not None:
                n_split += 1
                assert got == RowShard(tp, shape[0] if len(shape) == 3 else 1), (net, pname)
    assert n_split > 0

    if not by_value:
        return

    def trailing(path, leaf):
        if not leaf.shape:
            return np.zeros((), np.float32)
        return np.broadcast_to(np.arange(leaf.shape[-1], dtype=np.float32), leaf.shape)

    g_val, d_val = _port_names(cfg, *trees, trailing)
    for net, vals in (("g", g_val), ("d", d_val)):
        for pname, t in vals.items():
            rows = port[f"{net}.{pname}"]
            if rows is None:
                continue
            n = int(t.max().item()) + 1
            for m in range(tp):
                got = torch.unique(rows.take(t, m)).tolist()
                assert got == list(range(m * n // tp, (m + 1) * n // tp)), (net, pname, m)


class _Grid:
    """A stand-in for a ``Mesh`` of tp = 2 (no process group: the checks
    below raise before any collective)."""

    tp, model_rank = 2, 0


def test_shard_model_refuses_a_split_bias_before_changing_anything():
    from xmc_gan_tpu_torch.ops.modules import SNConv
    from xmc_gan_tpu_torch.parallel import shard_model

    layer = SNConv(4, 8, 3, padding=1, gen=torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in layer.state_dict().items()}
    with pytest.raises(NotImplementedError, match="bias"):
        shard_model(layer, _Grid(), tp_min_size=1)
    assert layer.shard is None and getattr(layer, "tp_mesh", None) is None
    assert all(torch.equal(v, before[k]) for k, v in layer.state_dict().items())


def test_tp_step_refuses_an_unsplit_state():
    from xmc_gan_tpu_torch.train import create_train_state, make_train_step

    cfg = CONFIGS["flagship_word"][1]
    state = create_train_state(cfg, device="cpu")
    with pytest.raises(ValueError, match="shard_state"):
        make_train_step(cfg, mesh=_Grid())(state, {}, None)
