"""The port's dataset tools (``xmc_gan_tpu_torch/data/coco_prep.py``,
``data/ln_prep.py``) against the JAX package's (``xmc_gan_tpu/data/``): the
same synthetic annotation files go through both, and every pickle they write
must hold equal objects; then the port's data pipeline reads the prepared
directory, and the CLI's ``prep-coco`` / ``prep-ln`` write the same files."""

import json
import os
import pickle

import numpy as np
import pytest

from xmc_gan_tpu.data import coco_prep as jcoco
from xmc_gan_tpu.data import ln_prep as jln
from xmc_gan_tpu_torch import cli
from xmc_gan_tpu_torch.config import cfg_from_dict
from xmc_gan_tpu_torch.data import coco_prep as pcoco
from xmc_gan_tpu_torch.data import ln_prep as pln
from xmc_gan_tpu_torch.data.pipeline import SentTextDataset, WordTextDataset

COCO_FILES = ("train/filenames.pickle", "test/filenames.pickle", "captions.pickle",
              "bert_captions.pickle")
LN_FILES = ("train/filenames.pickle", "test/filenames.pickle", "bert_captions.pickle")


def _coco_json(path, split, n_images, caps, start_id=0):
    """A minimal official-schema COCO caption file; ``caps`` maps image
    index -> captions (a missing index has no annotation)."""
    images, annotations = [], []
    for i in range(n_images):
        img_id = start_id + i
        images.append({"id": img_id, "file_name": f"COCO_{split}2014_{img_id:012d}.jpg",
                       "height": 32, "width": 32})
        for cap in caps.get(i, []):
            annotations.append({"id": len(annotations) + 1, "image_id": img_id,
                                "caption": cap})
    # an annotation of an image the file does not list is ignored
    annotations.append({"id": len(annotations) + 1, "image_id": 10**6, "caption": "lost"})
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": annotations}, f)


def _coco_files(root):
    """Train and val annotation files with the edge cases: an empty and a
    punctuation-only caption (filled from a valid one), non-ASCII tokens, an
    image with no valid caption (dropped), one with no annotation at all."""
    train = {0: ["A man riding a SKATEBOARD!", "", "a man on a board", "two dogs",
                 "a dog   runs", "extra sixth caption"],
             1: ["café��shop sign", "!!!"],
             2: ["...", "   "],
             4: ["Zebras éé 42 grazing"]}
    val = {0: ["a cat on a mat"], 1: ["a dog near the zebras", "birds flying overhead"],
           3: ["?"]}
    tj, vj = root / "captions_train2014.json", root / "captions_val2014.json"
    _coco_json(tj, "train", 5, train)
    _coco_json(vj, "val", 4, val, start_id=100)
    return str(tj), str(vj)


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _same_files(a, b, names):
    for name in names:
        assert _load(a / name) == _load(b / name), name


def _write_images(data_dir, keys, size=32):
    from PIL import Image

    os.makedirs(data_dir / "images", exist_ok=True)
    rng = np.random.RandomState(0)
    for key in keys:
        Image.fromarray(rng.randint(0, 255, (size, size, 3), np.uint8)).save(
            data_dir / "images" / f"{key}.jpg")


def test_tokenizer_and_vocabulary_match_jax():
    for cap in ("A man, riding; a SKATEBOARD!", "café��shop", "éé 42 dogs", "", "!!!"):
        assert pcoco.tokenize_caption(cap) == jcoco.tokenize_caption(cap)
    tokens = [["a", "man"], ["the", "man", "runs"], []]
    vocab = pcoco.build_vocabulary(tokens)
    assert vocab == jcoco.build_vocabulary(tokens)
    assert pcoco.encode_captions(tokens + [["oov", "a"]], vocab[1]) == \
        jcoco.encode_captions(tokens + [["oov", "a"]], vocab[1])


@pytest.mark.parametrize("caps_per_image", [5, 2])
def test_prepare_coco_matches_jax_and_feeds_the_pipeline(tmp_path, caps_per_image):
    tj, vj = _coco_files(tmp_path)
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    want = jcoco.prepare_coco(str(jdir), tj, vj, caps_per_image=caps_per_image)
    got = pcoco.prepare_coco(str(pdir), tj, vj, caps_per_image=caps_per_image)
    assert got == want
    assert want["dropped_train"] == 2 and want["dropped_test"] == 2
    _same_files(jdir, pdir, COCO_FILES)
    assert pcoco.read_coco_annotations(tj) == jcoco.read_coco_annotations(tj)

    cfg = cfg_from_dict({"IMG": {"SIZE": 32},
                         "TEXT": {"CAPTIONS_PER_IMAGE": caps_per_image, "MAX_LENGTH": 6}})
    train = _load(pdir / "train/filenames.pickle")
    _write_images(pdir, train + _load(pdir / "test/filenames.pickle"))
    words = WordTextDataset(str(pdir), "train", cfg)
    sents = SentTextDataset(str(pdir), "train", cfg)
    assert len(words) == len(sents) == len(train) == 3
    for i in range(len(words)):
        ex = words[i]
        assert ex["imgs"].shape == (32, 32, 3) and 1 <= ex["cap_lens"] <= 6
        assert (ex["caps"][:ex["cap_lens"]] != 0).all()
        assert isinstance(sents[i]["caps"], str)


def test_prepare_coco_vocab_from_matches_jax(tmp_path):
    """``vocab_from`` keeps an existing vocabulary index-exact; its OOV
    tokens drop, and a caption left empty by the drop counts as invalid."""
    tj, vj = _coco_files(tmp_path)
    base = tmp_path / "base"
    base.mkdir()
    i2w = {0: "<end>", 1: "a", 2: "man", 3: "dog", 4: "cat", 5: "zebras"}
    with open(base / "captions.pickle", "wb") as f:
        pickle.dump([[], [], i2w, {w: i for i, w in i2w.items()}], f)
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    kw = dict(caps_per_image=3, vocab_from=str(base / "captions.pickle"))
    want = jcoco.prepare_coco(str(jdir), tj, vj, **kw)
    assert pcoco.prepare_coco(str(pdir), tj, vj, **kw) == want
    assert want["voca_size"] == len(i2w)
    _same_files(jdir, pdir, COCO_FILES)


def _ln_jsonl(path, records):
    with open(path, "w") as f:
        for image_id, caption in records:
            f.write(json.dumps({"dataset_id": "mscoco_train2017", "image_id": image_id,
                                "annotator_id": 7, "caption": caption,
                                "timed_caption": [], "traces": []}) + "\n")
        f.write("\n")  # a blank line is skipped


@pytest.mark.parametrize("key_format,caps_per_image", [("{}", 1), ("COCO_train2014_{:012d}", 2),
                                                       ("{:012d}", 1)])
def test_prepare_localized_narratives_matches_jax(tmp_path, key_format, caps_per_image):
    """Two train files (an image narrated in both, an empty narration
    skipped) and one test file; numeric and hex ids through ``key_format``."""
    t1, t2, v = tmp_path / "t1.jsonl", tmp_path / "t2.jsonl", tmp_path / "v.jsonl"
    _ln_jsonl(t1, [("137576", "In this image we can see a dog."), ("42", "   "),
                   ("42", "A person holds a kite."), ("7", "Two cats.")])
    _ln_jsonl(t2, [("137576", "A second narration."), ("9", "A red bus on a road.")])
    hex_id = "0a1b2c" if key_format == "{}" else "88"  # OpenImages-style ids are hex
    _ln_jsonl(v, [("5", "A boat."), (hex_id, "A tree."), ("77", "A plane in the sky.")])
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    args = ([str(t1), str(t2)], [str(v)])
    kw = dict(caps_per_image=caps_per_image, key_format=key_format)
    want = jln.prepare_localized_narratives(str(jdir), *args, **kw)
    assert pln.prepare_localized_narratives(str(pdir), *args, **kw) == want
    _same_files(jdir, pdir, LN_FILES)
    assert pln.read_ln_jsonl([str(t1), str(t2)]) == jln.read_ln_jsonl([str(t1), str(t2)])

    cfg = cfg_from_dict({"IMG": {"SIZE": 32}, "TEXT": {"CAPTIONS_PER_IMAGE": caps_per_image}})
    _write_images(pdir, _load(pdir / "test/filenames.pickle"))
    test = SentTextDataset(str(pdir), "test", cfg)
    sent_ix = 1 if caps_per_image > 1 else 0  # the reference's fixed caption slot
    assert [test[i]["caps"] for i in range(len(test))] == \
        _load(pdir / "bert_captions.pickle")[1][sent_ix::caps_per_image]


def test_cli_prep_coco_and_prep_ln_write_the_jax_files(tmp_path, capsys):
    tj, vj = _coco_files(tmp_path)
    jcoco.prepare_coco(str(tmp_path / "jax_coco"), tj, vj)
    assert cli.main(["prep-coco", "--data_dir", str(tmp_path / "coco"), "--train_json", tj,
                     "--test_json", vj]) == 0
    assert "'train_images': 3" in capsys.readouterr().out
    _same_files(tmp_path / "jax_coco", tmp_path / "coco", COCO_FILES)

    t, v = tmp_path / "t.jsonl", tmp_path / "v.jsonl"
    _ln_jsonl(t, [("1", "A dog."), ("2", "A cat.")])
    _ln_jsonl(v, [("3", "A bird.")])
    jln.prepare_localized_narratives(str(tmp_path / "jax_ln"), [str(t)], [str(v)],
                                     key_format="{:012d}")
    argv = ["prep-ln", "--data_dir", str(tmp_path / "ln"), "--train_jsonl", str(t),
            "--test_jsonl", str(v), "--key_format", "{:012d}"]
    assert cli.main(argv) == 0
    assert "{'train': 2, 'test': 1}" in capsys.readouterr().out
    _same_files(tmp_path / "jax_ln", tmp_path / "ln", LN_FILES)
    with pytest.raises(NotImplementedError, match="stsb-roberta-base"):
        cli.main(argv + ["--build_cache"])
