"""The port's data path against the JAX package's: ``data/pipeline.py``
(datasets, transforms, ``DataLoader``), ``data/toy.py``, ``data/native.py``
and ``registry.get_dataset``.

The loaders must give the JAX loaders' batches bit for bit (uint8 images,
caption ids, ``cap_lens``, keys) for the same seed and epoch: the same
numpy draws and the same PIL calls on both sides.  Both packages take the
PIL route here (their ``native.available`` patched to False), whatever this
machine has.  The native route is held to the port's PIL route within the
resampling tolerance of ``tests/test_native_decode.py`` (the same decode,
libjpeg in both; the resize filters agree to a few uint8 LSBs).
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from torch_port_helpers import small_cfgs
from xmc_gan_tpu.data import native as jax_native
from xmc_gan_tpu.data import pipeline as jax_pipeline
from xmc_gan_tpu.data import toy as jax_toy
from xmc_gan_tpu_torch import registry
from xmc_gan_tpu_torch.data import native, pipeline, toy

REPO = Path(__file__).resolve().parents[1]
N_IMAGES, CPI, SIZE = 6, 5, 64
# native decode vs PIL, the same JPEG: uint8 LSBs (test_native_decode.py)
NATIVE_TOL = 5


def _cfgs():
    return small_cfgs({"IMG": {"SIZE": SIZE},
                       "TEXT": {"MAX_LENGTH": 8, "CAPTIONS_PER_IMAGE": CPI, "VOCA_SIZE": 40}})


@pytest.fixture(scope="module")
def disk_dataset(tmp_path_factory):
    """A tiny dataset in the reference on-disk format (dataset.py:43-101):
    JPEGs of two shapes (one larger than 4x the resize target, so the
    decode's DCT scaling engages), filenames, integer and raw captions."""
    from PIL import Image

    root = tmp_path_factory.mktemp("coco")
    for d in ("train", "test", "images"):
        os.makedirs(root / d)
    names = [f"img_{i:03d}" for i in range(N_IMAGES)]
    rng = np.random.RandomState(0)
    for i, name in enumerate(names):
        shape = (300, 340, 3) if i == 0 else (90, 70, 3)
        Image.fromarray(rng.randint(0, 255, shape, np.uint8)).save(root / "images" / f"{name}.jpg")
    for mode in ("train", "test"):
        with open(root / mode / "filenames.pickle", "wb") as f:
            pickle.dump(names, f)
    i2w = {i: f"w{i}" for i in range(40)}
    caps = [rng.randint(1, 40, rng.randint(2, 12)).tolist() for _ in range(N_IMAGES * CPI)]
    with open(root / "captions.pickle", "wb") as f:
        pickle.dump((caps, caps[::-1], i2w, {v: k for k, v in i2w.items()}), f)
    sents = [f"sentence number {i} here" for i in range(N_IMAGES * CPI)]
    with open(root / "bert_captions.pickle", "wb") as f:
        pickle.dump((sents, sents[::-1]), f)
    return str(root)


@pytest.fixture
def pil_route(monkeypatch):
    """Both packages decode with PIL."""
    monkeypatch.setattr(jax_native, "available", lambda: False)
    monkeypatch.setattr(native, "available", lambda: False)


def _assert_batches_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, k
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            assert list(g) == list(w), k


def _both(kind: str, disk_dataset, mode: str):
    jcfg, cfg = _cfgs()
    if kind == "synthetic":
        return (jax_pipeline.SyntheticDataset(jcfg, 10, mode),
                pipeline.SyntheticDataset(cfg, 10, mode))
    cls = {"word": "WordTextDataset", "sent": "SentTextDataset"}[kind]
    return (getattr(jax_pipeline, cls)(disk_dataset, mode, jcfg),
            getattr(pipeline, cls)(disk_dataset, mode, cfg))


LOADERS = {  # DataLoader options, epoch, start_batch
    "plain": ({"batch_size": 2}, 0, 0),
    "shuffled": ({"batch_size": 2, "shuffle": True, "seed": 5}, 3, 0),
    "shard_0_of_2": ({"batch_size": 2, "shuffle": True, "seed": 5, "shard": (0, 2)}, 1, 0),
    "shard_1_of_2": ({"batch_size": 2, "shuffle": True, "seed": 5, "shard": (1, 2)}, 1, 0),
    "start_batch": ({"batch_size": 2, "shuffle": True, "seed": 7, "drop_last": True}, 2, 1),
    "four_threads": ({"batch_size": 3, "shuffle": True, "seed": 9, "num_threads": 4}, 0, 0),
}


@pytest.mark.parametrize("loader", sorted(LOADERS))
@pytest.mark.parametrize("mode", ["train", "test"])
@pytest.mark.parametrize("kind", ["word", "sent", "synthetic"])
def test_loader_batches_match_jax(kind, mode, loader, disk_dataset, pil_route):
    """Every batch of an epoch, bit for bit: images (train crops and flips
    from the per-example RNG), caption ids or strings, lengths, keys."""
    jds, pds = _both(kind, disk_dataset, mode)
    opts, epoch, start = LOADERS[loader]
    opts = {"num_threads": 1, **opts}
    jl, pl = jax_pipeline.DataLoader(jds, **opts), pipeline.DataLoader(pds, **opts)
    assert len(pl) == len(jl)
    for ld in (jl, pl):
        ld.set_epoch(epoch, start_batch=start)
    jb, pb = list(jl), list(pl)
    assert len(pb) == len(jb) == len(jl) - start > 0
    for got, want in zip(pb, jb):
        _assert_batches_equal(got, want)


@pytest.mark.parametrize("kind", ["word", "synthetic"])
def test_first_batch_matches_jax_and_keeps_start_batch(kind, disk_dataset, pil_route):
    jds, pds = _both(kind, disk_dataset, "train")
    jl = jax_pipeline.DataLoader(jds, 2, shuffle=True, seed=3, num_threads=1)
    pl = pipeline.DataLoader(pds, 2, shuffle=True, seed=3, num_threads=1)
    for ld in (jl, pl):
        ld.set_epoch(4, start_batch=1)
    _assert_batches_equal(pl.first_batch(), jl.first_batch())
    assert pl.start_batch == 1  # first_batch does not consume the skip
    _assert_batches_equal(next(iter(pl)), next(iter(jl)))  # the skip applies here
    assert pl.start_batch == 0


def test_batches_do_not_depend_on_threads(disk_dataset, pil_route):
    _, pds = _both("word", disk_dataset, "train")
    runs = []
    for threads in (1, 4):
        ld = pipeline.DataLoader(pds, 2, shuffle=True, seed=1, num_threads=threads)
        ld.set_epoch(2)
        runs.append(list(ld))
    for a, b in zip(*runs):
        _assert_batches_equal(a, b)


@pytest.mark.parametrize("mode", ["train", "test"])
def test_synthetic_salts_match_jax_and_keep_splits_apart(mode):
    """The test split's salt: test example i is not train example i."""
    jcfg, cfg = _cfgs()
    for seed, epoch, idx in ((0, 0, 0), (11, 2, 7)):
        want = jax_pipeline.SyntheticDataset(jcfg, 10, mode)[(idx, epoch, seed)]
        got = pipeline.SyntheticDataset(cfg, 10, mode)[(idx, epoch, seed)]
        _assert_batches_equal({k: np.asarray(v) for k, v in got.items()},
                              {k: np.asarray(v) for k, v in want.items()})
    tr = pipeline.SyntheticDataset(cfg, 10, "train")[(0, 0, 0)]["imgs"]
    te = pipeline.SyntheticDataset(cfg, 10, "test")[(0, 0, 0)]["imgs"]
    assert not np.array_equal(tr, te)


def test_word_dataset_reference_quirks(disk_dataset, pil_route):
    """The fixed second caption (sent_ix = 1, reference dataset.py:50-52)
    and the caption padding of get_caption."""
    _, cfg = _cfgs()
    ds = pipeline.WordTextDataset(disk_dataset, "train", cfg)
    ex = ds[(2, 0, 0)]
    assert ex["cap_idx"] == 2 * CPI + 1
    cap = ds.captions[2 * CPI + 1][:8]
    assert ex["cap_lens"] == len(cap)
    np.testing.assert_array_equal(ex["caps"][: len(cap)], cap)
    assert not ex["caps"][len(cap):].any()


def test_index_to_sent_matches_jax(disk_dataset):
    _, cfg = _cfgs()
    ds = pipeline.WordTextDataset(disk_dataset, "test", cfg)
    caps = np.stack([ds[(i, 0, 0)]["caps"] for i in range(3)])
    assert pipeline.index_to_sent(ds.i2w, caps) == jax_pipeline.index_to_sent(ds.i2w, caps)


@pytest.mark.parametrize("size", [64, 32])
@pytest.mark.parametrize("dct_scale", ["1", "0"])
def test_pil_load_image_matches_jax(size, dct_scale, disk_dataset, pil_route, monkeypatch):
    """``load_image`` on the PIL route, with and without the DCT-scaled
    ``draft`` decode, train (crop and flip draws) and test."""
    monkeypatch.setenv("XMC_DCT_SCALE", dct_scale)
    path = f"{disk_dataset}/images/img_000.jpg"
    for mode in ("train", "test"):
        want = jax_pipeline.load_image(path, size, mode, np.random.default_rng(4))
        got = pipeline.load_image(path, size, mode, np.random.default_rng(4))
        np.testing.assert_array_equal(got, want)


def test_toy_data_matches_jax():
    rng_j, rng_p = np.random.RandomState(3), np.random.RandomState(3)
    attrs = toy.sample_attrs(rng_p, 16)
    np.testing.assert_array_equal(attrs, jax_toy.sample_attrs(rng_j, 16))
    imgs = toy.render(attrs, 32)
    np.testing.assert_array_equal(imgs, jax_toy.render(attrs, 32))
    caps, lens = toy.make_captions(attrs)
    jcaps, jlens = jax_toy.make_captions(attrs)
    np.testing.assert_array_equal(caps, jcaps)
    np.testing.assert_array_equal(lens, jlens)
    for got, want in zip(toy.encode_captions(caps, 12), jax_toy.encode_captions(jcaps, 12)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(toy.classify_color(imgs), jax_toy.classify_color(imgs))
    np.testing.assert_array_equal(toy.classify_position(imgs), jax_toy.classify_position(imgs))
    np.testing.assert_array_equal(toy.classify_color(imgs), attrs[:, 0])
    assert toy.VOCAB == jax_toy.VOCAB


def test_get_dataset():
    assert registry.get_dataset("WORD") is pipeline.WordTextDataset
    with pytest.raises(NotImplementedError, match="SBERT"):
        registry.get_dataset("SENT")
    with pytest.raises(KeyError):
        registry.get_dataset("IMAGES")


def test_decode_route(disk_dataset, pil_route):
    _, cfg = _cfgs()
    assert pipeline.decode_route(pipeline.SyntheticDataset(cfg, 4)) == "synthetic"
    assert pipeline.decode_route(pipeline.WordTextDataset(disk_dataset, "train", cfg)) == "PIL"


# --------------------------------------------------------------- native route


def _native_or_skip():
    if not native.available():
        pytest.skip("the port's native decoder did not build here (no g++ or libjpeg)")


def test_native_test_route_matches_the_pil_route(disk_dataset, monkeypatch):
    """``load_image`` in test mode on both routes: the decoded pixels within
    the resampling tolerance."""
    _native_or_skip()
    for name in ("img_000", "img_001"):
        path = f"{disk_dataset}/images/{name}.jpg"
        got = pipeline.load_image(path, SIZE, "test")
        with monkeypatch.context() as mp:
            mp.setattr(native, "available", lambda: False)
            want = pipeline.load_image(path, SIZE, "test")
        assert got.shape == want.shape == (SIZE, SIZE, 3) and got.dtype == np.uint8
        assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() < NATIVE_TOL, name


@pytest.mark.parametrize("u", [(0.0, 0.0, False), (0.999, 0.4, True), (0.3, 0.999, False)])
def test_native_train_crop_matches_pil(u, disk_dataset, monkeypatch):
    """``decode_train``: the shorter side resized to ``size * 76 / 64``, the
    crop at ``floor(u * (room + 1))`` and the flip, against the same
    resize, crop and flip in PIL, within the resampling tolerance.  (The
    routes draw their crop differently from the per-example RNG: uniform
    fractions here, ``integers`` in ``train_transform``.)"""
    from PIL import Image

    _native_or_skip()
    u_x, u_y, flip = u
    short = int(SIZE * 76 / 64)
    path = f"{disk_dataset}/images/img_001.jpg"
    with open(path, "rb") as f:
        got = native.decode_train(f.read(), SIZE, short, u_x, u_y, flip, fast=False)
    with Image.open(path) as img:
        img = img.convert("RGB")
        w, h = img.size
        scale = short / min(w, h)
        img = img.resize((max(short, round(w * scale)), max(short, round(h * scale))),
                         Image.BILINEAR)
        left = int(u_x * (img.size[0] - SIZE + 1))
        top = int(u_y * (img.size[1] - SIZE + 1))
        want = np.asarray(img.crop((left, top, left + SIZE, top + SIZE)))
    if flip:
        want = want[:, ::-1]
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() < NATIVE_TOL


def test_native_corrupt_jpeg_returns_none():
    _native_or_skip()
    assert native.decode_test(b"not a jpeg at all", 64) is None
    assert native.decode_train(b"\xff\xd8\xff\xe0garbage", 64, 76, 0.5, 0.5, False) is None


_BUILD = ("import ctypes, sys\n"
          "from pathlib import Path\n"
          "from xmc_gan_tpu_torch.data import native\n"
          "path = native.build(Path(sys.argv[1]))\n"
          "ctypes.CDLL(str(path)).xmc_decode_test\n"
          "print(path.name)\n")


def _env():
    return {**{k: v for k, v in os.environ.items() if k != "PYTHONPATH"}, "PYTHONPATH": str(REPO)}


def test_concurrent_builds_both_load(tmp_path):
    """Two processes build the binding into one empty directory at once:
    each compiles to its own temporary file and renames it into place, so
    both load a whole library and no temporary file is left."""
    _native_or_skip()
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(tmp_path)], cwd=REPO,
                              env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=180) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    names = {out.strip() for out, _ in outs}
    assert len(names) == 1 and sorted(os.listdir(tmp_path)) == sorted(names)


def test_native_decode_can_be_turned_off():
    code = "from xmc_gan_tpu_torch.data import native; print(native.available())"
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, env={**_env(), "XMC_NATIVE_DECODE": "0"}, timeout=60,
                         check=True)
    assert out.stdout.strip() == "False"
