"""One tensor-parallel fp32 train step (gloo ranks, ``tests/torch_dp_workers.py``'s
``job_tp_step``) on ``dp = 2 x tp = 2`` and ``dp = 1 x tp = 2`` meshes, the
state split by ``parallel.shard_state`` at ``tp_min_size = 1 << 12`` (the
JAX package's test size, ``tests/test_parallel.py``), from the same
converted state, JAX noise draw and batch as ``tests/test_torch_dp_step.py``
(``tests/torch_dp_step_parity.py``).

* ``flagship_word`` (``df_gan_damsm.yml`` with WORD, B_GLOBAL, SPEC_NORM,
  MAGP and RMIS: G's affine MLPs and convs, D's SN convs and ``proj_match``
  split; the word scores as column blocks): against the JAX package's
  single-device step with ``tests/torch_step_parity.py``'s tolerances
  (metrics to 1e-4 relative; 99.9% of each network's elements within lr / 20
  and every element within 2 lr; the spectral vectors to 1e-5), and against
  the port's one-process step with ``torch_dp_step_parity``'s (metrics to
  1e-5 relative; every element within 2 lr, 99.9% within 1e-5).
* ``concept_df`` (``concept_out_df_gan.yml``: CONCEPT_OUT_DF_GEN and
  CONCEPT_NETD, grouped convs split by whole groups, grouped dense layers
  split inside each group, spectral norm, MAGP's double backward through
  the split layers): against the port's one-process step, with the same
  tolerances.

On every mesh: each rank's replicated leaves are bit-equal to every other
rank's, its split weights hold ``1/tp`` of the rows (the same rows on the
ranks of one model index), and so do their Adam moments.
"""

import pytest
import torch

from torch_dp_step_parity import (
    check_dp_vs_jax_metrics,
    check_dp_vs_jax_params,
    check_dp_vs_one_process,
    run_tp_step,
)
from torch_port_helpers import one_torch_thread  # noqa: F401  (fixture)

MESHES = ((2, 2), (1, 2))
TP_MIN_SIZE = 1 << 12


@pytest.fixture(scope="module")
def flagship(one_torch_thread, tmp_path_factory):
    return run_tp_step("flagship_word", tmp_path_factory.mktemp("tp_flagship"), MESHES,
                       TP_MIN_SIZE)


@pytest.fixture(scope="module")
def concept(one_torch_thread, tmp_path_factory):
    return run_tp_step("concept_df", tmp_path_factory.mktemp("tp_concept"), MESHES,
                       TP_MIN_SIZE, with_jax=False)


def _check_layout(run: dict, tp: int) -> None:
    ranks = run["ranks"]
    for net in ("g", "d"):
        split = set(ranks[0]["split"][net])
        assert split, f"no split weight in {net}"
        for r in ranks:
            assert set(r["split"][net]) == split
            for name, local in r["local"][net].items():
                whole = r[net][name]
                if name in split:
                    assert local.shape[0] * tp == whole.shape[0], (net, name)
                else:
                    assert torch.equal(local, whole), (net, name)
        # the moments of a split weight are its rows'
        shapes = {tuple(r["local"][net][n].shape) for r in ranks for n in split}
        moments = set(ranks[0]["moments"][net])
        assert shapes <= moments, (net, shapes - moments)
    for a in ranks:
        for b in ranks:
            if a is b:
                continue
            assert a["metrics"] == b["metrics"]
            for net in ("g", "d"):
                for name, v in a["local"][net].items():
                    if name not in a["split"][net] or a["model_rank"] == b["model_rank"]:
                        assert torch.equal(v, b["local"][net][name]), (net, name)
                for name, v in a[net].items():  # the whole state, gathered
                    assert torch.equal(v, b[net][name]), (net, name)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"dp{m[0]}_tp{m[1]}")
def test_tp_step_metrics_match_jax(flagship, mesh):
    check_dp_vs_jax_metrics(flagship["meshes"][mesh])


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"dp{m[0]}_tp{m[1]}")
def test_tp_step_params_and_vectors_match_jax(flagship, mesh):
    check_dp_vs_jax_params(flagship["meshes"][mesh])


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"dp{m[0]}_tp{m[1]}")
def test_tp_step_matches_the_one_process_step(flagship, mesh):
    check_dp_vs_one_process(flagship["meshes"][mesh])


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"dp{m[0]}_tp{m[1]}")
def test_tp_shards_and_replicas(flagship, mesh):
    _check_layout(flagship["meshes"][mesh], mesh[1])


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"dp{m[0]}_tp{m[1]}")
def test_tp_concept_step_matches_the_one_process_step(concept, mesh):
    check_dp_vs_one_process(concept["meshes"][mesh])
    _check_layout(concept["meshes"][mesh], mesh[1])
