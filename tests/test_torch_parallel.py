"""The port's collectives (``xmc_gan_tpu_torch/parallel``) on two gloo ranks
(``tests/torch_dp_workers.py``) against the JAX package's on a dp=2 mesh of
the simulated CPU devices and against its single-device functions on the
concatenated batch, in value and gradient.  The ranks' gradients are each
rank's own divided by the world size (the data-parallel mean), as
``tests/test_parallel.py`` divides the JAX replicas' by ``psum(1)``.

* ``all_gather_with_grad``: the tiled gather, and its transpose
  (``psum_scatter``: the cotangent summed over the ranks, each keeping its
  rows).
* ``global_sent_loss`` against ``losses.sent_loss`` on the whole batch and
  ``make_sharded_sent_loss``; its gradient against the JAX replicas'.
* ``sharded_word_scores``: scores and ``d_regions`` (and ``d_words``) against
  ``make_sharded_word_scores`` (dp=2, tp=1) and the single-device scores, at
  ``tests/test_parallel.py``'s tolerances (rtol 1e-5 and 1e-4).
* The global-batch ``_batch_norm`` of ``models/concept_gan.py`` against the
  JAX module's ``_batch_norm`` on the whole batch.
* ``mismatch_pairs``: RMIS pairs image i with sentence i + 1 across the
  rank boundary; the last rank drops its last image; ``B - 1`` pairs.

Tensor parallelism (``job_tp_collectives``), ``dp = 2 x tp = 2`` (4 ranks)
and ``dp = 2 x tp = 4`` (8 ranks):

* ``sharded_word_scores``' column blocks ``[B_local, B/tp]`` against
  ``make_sharded_word_scores`` on ``make_mesh(dp=2, tp=2)`` and the
  single-device scores, values and gradients at ``tests/test_parallel.py``'s
  tolerances; at B = 6, tp = 4 (``tests/test_parallel.py:131``: tp does not
  divide B) every rank scores the full columns, held to the JAX (2, 4) mesh.
* A column-parallel spectral-normalized ``SNConv`` (its 8 output rows split
  4 + 4): output, input gradient, and a MAGP-style double backward's weight
  (this rank's rows) and bias gradients, and the refreshed vectors, against
  the same layer whole on the same rank, to 1e-6 relative (1e-5 for the
  bias's gradient, a sum over every pixel).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from torch_dp_workers import Ranks, launch
from xmc_gan_tpu import losses
from xmc_gan_tpu.models.concept_gan import _batch_norm as jax_batch_norm
from xmc_gan_tpu.parallel import make_mesh
from xmc_gan_tpu.parallel.collectives import (
    global_sent_loss,
    make_sharded_sent_loss,
    make_sharded_word_scores,
    shard_map,
)

WORLD = 2
B, D = 8, 6
SENT_ARGS = (True, 0.0)


def _spec() -> dict:
    rng = np.random.RandomState(0)
    spec = {
        "img": rng.randn(B, D), "txt": rng.randn(B, D), "sent": rng.randn(B, 5),
        "gather_cot": rng.randn(B, D), "args": {"sent": SENT_ARGS},
        "regions": rng.randn(16, 8, 8), "words": rng.randn(16, 6, 8),
        "mask": rng.rand(16, 6) > 0.7, "word_cot": rng.randn(16, 16),
        "bn_x": rng.randn(4, 3, 5, 5), "bn_scale": rng.rand(3) + 0.5, "bn_bias": rng.randn(3),
        "bn_cot": rng.randn(4, 3, 5, 5),
        "rmis_feats": np.arange(B)[:, None].repeat(3, 1) * 1.0,
        "rmis_sent": 100.0 + np.arange(B)[:, None],
    }
    spec["mask"][:, 0] = False  # no all-padded caption (tests/test_parallel.py's inputs)
    return {k: v.astype(np.float32) if isinstance(v, np.ndarray) and v.dtype == np.float64
            else v for k, v in spec.items()}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    spec = _spec()
    return spec, launch("collectives", tmp_path_factory.mktemp("collectives"), WORLD, spec=spec)


def _cat(ranks, key):
    return np.concatenate([np.asarray(r[key]) for r in ranks])


def test_all_gather_with_grad_value_and_transpose(run, eight_devices):
    spec, ranks = run
    mesh = make_mesh(dp=WORLD, tp=1)
    cot = jnp.asarray(spec["gather_cot"])

    def per_replica(x):
        return jax.grad(lambda v: jnp.sum(jax.lax.all_gather(v, "data", tiled=True) * cot))(x)

    f = shard_map(per_replica, mesh=mesh, in_specs=P("data", None),
                  out_specs=P("data", None), check_rep=False)
    want = np.asarray(jax.jit(f)(jax.device_put(jnp.asarray(spec["img"]),
                                       NamedSharding(mesh, P("data", None)))))
    for r in ranks:
        np.testing.assert_array_equal(np.asarray(r["gather"]), spec["img"])
    np.testing.assert_allclose(_cat(ranks, "gather_grad"), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(want, WORLD * spec["gather_cot"], rtol=1e-6)


def test_global_sent_loss_matches_jax(run, eight_devices):
    spec, ranks = run
    img, txt, sent = (jnp.asarray(spec[k]) for k in ("img", "txt", "sent"))
    labels = losses.make_labels(sent, *SENT_ARGS)
    want = float(losses.sent_loss(img, txt, labels, *SENT_ARGS))
    mesh = make_mesh(dp=WORLD, tp=1)
    spec2 = NamedSharding(mesh, P("data", None))
    sharded = float(jax.jit(make_sharded_sent_loss(mesh, *SENT_ARGS))(
        *(jax.device_put(x, spec2) for x in (img, txt, sent))))
    for r in ranks:
        np.testing.assert_allclose(float(r["sent_loss"]), want, rtol=1e-5)
        np.testing.assert_allclose(float(r["sent_loss"]), sharded, rtol=1e-5)

    def per_replica(i, t, s):
        g = jax.grad(lambda v: global_sent_loss(v, t, s, *SENT_ARGS))(i)
        return g / jax.lax.psum(1, "data")

    f = shard_map(per_replica, mesh=mesh, in_specs=(P("data", None),) * 3,
                  out_specs=P("data", None), check_rep=False)
    want_g = np.asarray(jax.jit(f)(*(jax.device_put(x, spec2) for x in (img, txt, sent))))
    single_g = np.asarray(jax.jit(jax.grad(
        lambda v: losses.sent_loss(v, txt, labels, *SENT_ARGS)))(img))
    got_g = _cat(ranks, "sent_grad")
    np.testing.assert_allclose(got_g, want_g, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got_g, single_g, rtol=1e-4, atol=1e-6)


def test_sharded_word_scores_match_jax(run, eight_devices):
    spec, ranks = run
    regions, words = jnp.asarray(spec["regions"]), jnp.asarray(spec["words"])
    mask, cot = jnp.asarray(spec["mask"]), jnp.asarray(spec["word_cot"])

    def single(r, w):
        s = losses.word_region_scores(r, w, mask, 4.0, 5.0, block_elems=64)
        return jnp.sum(s * cot), s

    (want_val, want_s), (want_dr, want_dw) = jax.value_and_grad(
        single, argnums=(0, 1), has_aux=True)(regions, words)
    mesh = make_mesh(dp=WORLD, tp=1)
    sharded = make_sharded_word_scores(mesh, 4.0, 5.0, block_elems=64)

    def dist(r, w):
        s = sharded(r, w, mask)
        return jnp.sum(s * cot), s

    spec3 = NamedSharding(mesh, P("data", None, None))
    (mesh_val, mesh_s), (mesh_dr, _) = jax.jit(jax.value_and_grad(
        dist, argnums=(0, 1), has_aux=True))(jax.device_put(regions, spec3),
                                             jax.device_put(words, spec3))
    for r in ranks:
        for want in (want_s, mesh_s):
            np.testing.assert_allclose(np.asarray(r["scores"]), np.asarray(want),
                                       rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(float(r["word_val"]), float(want_val), rtol=1e-5)
        np.testing.assert_allclose(float(r["word_val"]), float(mesh_val), rtol=1e-5)
    for want in (want_dr, mesh_dr):
        np.testing.assert_allclose(_cat(ranks, "d_regions"), np.asarray(want), rtol=1e-4,
                                   atol=1e-6)
    np.testing.assert_allclose(_cat(ranks, "d_words"), np.asarray(want_dw), rtol=1e-4,
                               atol=1e-6)


def test_global_batch_norm_matches_jax_on_the_whole_batch(run):
    spec, ranks = run
    nhwc = functools.partial(np.transpose, axes=(0, 2, 3, 1))
    x, cot = jnp.asarray(nhwc(spec["bn_x"])), jnp.asarray(nhwc(spec["bn_cot"]))
    scale, bias = jnp.asarray(spec["bn_scale"]), jnp.asarray(spec["bn_bias"])

    def f(x, scale):
        return jnp.sum(jax_batch_norm(x, scale, bias) * cot)

    y = np.transpose(np.asarray(jax_batch_norm(x, scale, bias)), (0, 3, 1, 2))
    dx, dscale = (np.asarray(g) for g in jax.grad(f, argnums=(0, 1))(x, scale))
    np.testing.assert_allclose(_cat(ranks, "bn"), y, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_cat(ranks, "bn_dx"), np.transpose(dx, (0, 3, 1, 2)),
                               rtol=1e-4, atol=1e-5)
    # each rank's scale gradient is its rows' share; the sum is the whole batch's
    np.testing.assert_allclose(sum(np.asarray(r["bn_dscale"]) for r in ranks), dscale,
                               rtol=1e-4, atol=1e-5)


def test_rmis_pairs_cross_the_rank_boundary(run):
    spec, ranks = run
    n = B // WORLD
    for rank, r in enumerate(ranks):
        feats, sents, pairs = (np.asarray(v) for v in r["rmis"])
        first = rank * n
        count = n if rank < WORLD - 1 else n - 1
        assert pairs == B - 1
        np.testing.assert_array_equal(feats, spec["rmis_feats"][first:first + count])
        # image i against sentence i + 1 of the global batch
        np.testing.assert_array_equal(sents, spec["rmis_sent"][first + 1:first + 1 + count])
    assert sum(len(np.asarray(r["rmis"][0])) for r in ranks) == B - 1


TP_MESHES = {"dp2_tp2": (2, 2, dict(b=16, r=8, t=6, d=8)), "dp2_tp4": (2, 4, dict(b=6, r=4, t=5, d=8))}


def _tp_spec(b, r, t, d) -> dict:
    rng = np.random.RandomState(3)
    spec = {"regions": rng.randn(b, r, d), "words": rng.randn(b, t, d),
            "mask": rng.rand(b, t) > 0.7, "word_cot": rng.randn(b, b),
            "conv_x": rng.randn(3, 6, 5, 5), "conv_cot": rng.randn(3, 8, 5, 5)}
    spec["mask"][:, 0] = False
    return {k: v.astype(np.float32) if v.dtype == np.float64 else v for k, v in spec.items()}


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    started = {}
    for name, (dp, tp, shape) in TP_MESHES.items():
        spec = {**_tp_spec(**shape), "tp": tp, "sn_conv": name == "dp2_tp2"}
        started[name] = (spec, Ranks("tp_collectives", tmp_path_factory.mktemp(name), dp * tp,
                                     spec))
    return {name: (spec, ranks.join()) for name, (spec, ranks) in started.items()}


def _rows_cat(ranks, key, tp):
    """The data ranks' rows, in order (model rank 0 of each)."""
    return np.concatenate([np.asarray(r[key]) for r in ranks[::tp]])


@pytest.mark.parametrize("name", TP_MESHES)
def test_column_block_word_scores_match_jax(tp_runs, name, eight_devices):
    dp, tp, _ = TP_MESHES[name]
    spec, ranks = tp_runs[name]
    regions, words = jnp.asarray(spec["regions"]), jnp.asarray(spec["words"])
    mask, cot = jnp.asarray(spec["mask"]), jnp.asarray(spec["word_cot"])

    def single(r, w):
        s = losses.word_region_scores(r, w, mask, 4.0, 5.0, block_elems=32)
        return jnp.sum(s * cot), s

    (want_val, want_s), (want_dr, want_dw) = jax.value_and_grad(
        single, argnums=(0, 1), has_aux=True)(regions, words)
    mesh = make_mesh(dp=dp, tp=tp)
    sharded = make_sharded_word_scores(mesh, 4.0, 5.0, block_elems=32)

    def dist(r, w):
        s = sharded(r, w, mask)
        return jnp.sum(s * cot), s

    spec3 = NamedSharding(mesh, P("data", None, None))
    (mesh_val, mesh_s), (mesh_dr, mesh_dw) = jax.jit(jax.value_and_grad(
        dist, argnums=(0, 1), has_aux=True))(jax.device_put(regions, spec3),
                                             jax.device_put(words, spec3))
    for r in ranks:
        for want in (want_s, mesh_s):
            np.testing.assert_allclose(np.asarray(r["scores"]), np.asarray(want),
                                       rtol=1e-5, atol=1e-6)
        for want in (want_val, mesh_val):
            np.testing.assert_allclose(float(r["word_val"]), float(want), rtol=1e-5)
    # the ranks of one model group hold the same rows and the same gradients
    for r in ranks:
        lead = ranks[r["data_rank"] * tp]
        np.testing.assert_array_equal(np.asarray(r["d_regions"]), np.asarray(lead["d_regions"]))
    for want in (want_dr, mesh_dr):
        np.testing.assert_allclose(_rows_cat(ranks, "d_regions", tp), np.asarray(want),
                                   rtol=1e-4, atol=1e-6)
    for want in (want_dw, mesh_dw):
        np.testing.assert_allclose(_rows_cat(ranks, "d_words", tp), np.asarray(want),
                                   rtol=1e-4, atol=1e-6)


def test_bf16_model_sum_rounds_once(tp_runs):
    """A bf16 sum over the model group (``parallel.tensor._summed``, the
    column-parallel layers' input gradient): the parts added in fp32 and
    rounded once, the same bits on every rank of the group, in the input's
    memory format."""
    _, ranks = tp_runs["dp2_tp2"]
    for lead in ranks[::2]:
        group = [r for r in ranks if r["data_rank"] == lead["data_rank"]]
        want = sum(r["bf16_sum"][0].float() for r in group).bfloat16()
        for r in group:
            got = r["bf16_sum"][1]
            assert got.dtype == torch.bfloat16
            assert got.is_contiguous(memory_format=torch.channels_last)
            assert torch.equal(got, want)


def test_column_parallel_sn_conv_matches_the_whole_layer(tp_runs):
    _, ranks = tp_runs["dp2_tp2"]
    for r in ranks:
        whole, split = r["sn_conv"]["whole"], r["sn_conv"]["split"]
        for key in ("y", "gx", "gw", "gb", "u", "v"):
            a, b = np.asarray(split[key]), np.asarray(whole[key])
            rtol = 1e-5 if key == "gb" else 1e-6
            assert np.abs(a - b).max() <= rtol * np.abs(b).max(), (key, np.abs(a - b).max())
    # rows 0-3 on model rank 0, 4-7 on model rank 1: different parts of one gradient
    assert not np.array_equal(ranks[0]["sn_conv"]["split"]["gw"], ranks[1]["sn_conv"]["split"]["gw"])
