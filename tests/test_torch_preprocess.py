"""The port's preprocessing and corpus tools against the JAX package, on
the CPU.

``create_input_files`` on ``tests/test_data.py``'s corpus (6 images of
other sizes, 1-3 captions each, so both of the caption sampler's branches
run) and on a Karpathy-format English corpus, ``make_synthetic_corpus``,
``load_embeddings`` and ``corpus_score``.  The artifacts must be the same:
every JSON file byte-equal, every HDF5 dataset equal in shape, dtype and
values with the same attrs (the HDF5 files' bytes may differ), for
workers 1 and 8.  The English path tags nouns with nltk; its tagger data
may be missing here, so both packages' ``get_tags_en`` are replaced by one
deterministic stub whose counts tie, which ``Counter.most_common`` must
break the same way.
"""

import inspect
import json
import math
import os

import h5py
import numpy as np
import pytest
from PIL import Image

from indonesian_image_captioning_tpu.cli import corpus_score as jax_cs
from indonesian_image_captioning_tpu.cli import \
    create_input_files as jax_cli
from indonesian_image_captioning_tpu.data import preprocess as jax_pre
from indonesian_image_captioning_tpu.data import synthetic as jax_synth
from indonesian_image_captioning_tpu.utils import embedding as jax_emb
from indonesian_image_captioning_tpu_torch.cli import corpus_score as cs
from indonesian_image_captioning_tpu_torch.cli import create_input_files
from indonesian_image_captioning_tpu_torch.data import preprocess, synthetic
from indonesian_image_captioning_tpu_torch.utils import embedding

WORDS = ["anjing", "kucing", "bermain", "di", "taman", "bola", "anak",
         "laki", "perempuan", "rumput"]


@pytest.fixture(scope="module")
def tiny_corpus(tmp_path_factory):
    """tests/test_data.py's 6-image flickr10k-format corpus."""
    root = tmp_path_factory.mktemp("flickr10k")
    img_dir = root / "imgs"
    img_dir.mkdir()
    rng = np.random.default_rng(0)
    filenames, captions, tags = [], [], []
    for i in range(6):
        name = f"{i:04d}.jpg"
        Image.fromarray(rng.integers(0, 256, size=(20 + i, 30, 3),
                                     dtype=np.uint8)).save(img_dir / name)
        filenames.append(name)
        captions.append([" ".join(rng.choice(WORDS, 3 + (i + j) % 4).tolist())
                         for j in range(1 + (i % 3))])
        tags.append(list(rng.choice(["anjing", "kucing", "bola", "taman"],
                                    2, replace=False)))
    (root / "filenames.json").write_text(json.dumps(filenames))
    (root / "captions.json").write_text(json.dumps(captions))
    (root / "tags.json").write_text(json.dumps(tags))
    (root / "train.txt").write_text("\n".join(f"{i:04d}" for i in range(4)))
    (root / "val.txt").write_text("0004")
    (root / "test.txt").write_text("0005")
    (root / "all_tags.txt").write_text("anjing\nkucing\nbola\ntaman")
    return root, img_dir


def assert_same_artifacts(ours, theirs):
    names = sorted(os.listdir(ours))
    assert names == sorted(os.listdir(theirs)) and len(names) == 17
    for name in names:
        a, b = os.path.join(ours, name), os.path.join(theirs, name)
        if name.endswith(".json"):
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), name
            continue
        with h5py.File(a, "r") as ha, h5py.File(b, "r") as hb:
            assert dict(ha.attrs) == dict(hb.attrs), name
            assert sorted(ha) == sorted(hb), name
            for key in hb:
                x, y = ha[key][...], hb[key][...]
                assert (x.shape, x.dtype) == (y.shape, y.dtype), name
                np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.mark.parametrize("workers", [1, 8])
def test_create_input_files_matches_jax(tiny_corpus, tmp_path, workers):
    """The flickr10k path at 5 captions an image (images with fewer are
    padded by rng.choice, the others sampled by rng.sample) and
    max_len 4 (longer captions dropped)."""
    root, img_dir = tiny_corpus
    kw = dict(dataset="flickr10k", split_path=str(root),
              image_folder=str(img_dir), captions_per_image=5,
              min_word_freq=0, tag_size=4, max_len=4, image_size=40,
              workers=workers)
    ours = preprocess.create_input_files(output_folder=str(tmp_path / "a"),
                                         **kw)
    theirs = jax_pre.create_input_files(output_folder=str(tmp_path / "b"),
                                        **kw)
    assert sorted(ours) == sorted(theirs)
    assert_same_artifacts(tmp_path / "a", tmp_path / "b")


def noun_stub(tokens):
    """Words of more than four letters, as nltk's noun filter stands in."""
    return [t for t in tokens if len(t) > 4]


def test_english_path_matches_jax(tiny_corpus, tmp_path, monkeypatch):
    """A Karpathy-format corpus ("flickr8k", "restval" rows join TRAIN,
    a row of another split is dropped) with the noun tagger stubbed in
    both packages: the tag map takes the tag_size most common nouns,
    ties broken as JAX breaks them."""
    _, img_dir = tiny_corpus
    rng = np.random.default_rng(1)
    splits = ["train", "restval", "val", "test", "train", "extra"]
    images = [{"filename": f"{i:04d}.jpg", "split": splits[i],
               "sentences": [{"tokens": rng.choice(WORDS, 4).tolist()}
                             for _ in range(2 + i % 2)]}
              for i in range(6)]
    split_path = tmp_path / "dataset_flickr8k.json"
    split_path.write_text(json.dumps({"images": images}))
    for mod in (preprocess, jax_pre):
        monkeypatch.setattr(mod, "get_tags_en", noun_stub)
    kw = dict(dataset="flickr8k", split_path=str(split_path),
              image_folder=str(img_dir), captions_per_image=2,
              min_word_freq=1, tag_size=3, max_len=10, image_size=24,
              workers=2)
    preprocess.create_input_files(output_folder=str(tmp_path / "a"), **kw)
    jax_pre.create_input_files(output_folder=str(tmp_path / "b"), **kw)
    assert_same_artifacts(tmp_path / "a", tmp_path / "b")
    with pytest.raises(ValueError, match="dataset must be one of"):
        preprocess.create_input_files(output_folder=str(tmp_path / "c"),
                                      **{**kw, "dataset": "imagenet"})


@pytest.mark.parametrize("workers", [1, 8])
def test_synthetic_corpus_matches_jax(tmp_path, workers):
    ours = synthetic.make_synthetic_corpus(
        str(tmp_path / "a_root"), str(tmp_path / "a"), n_images=10, seed=3,
        workers=workers)
    theirs = jax_synth.make_synthetic_corpus(
        str(tmp_path / "b_root"), str(tmp_path / "b"), n_images=10, seed=3)
    assert type(ours).__module__ == \
        "indonesian_image_captioning_tpu_torch.core.config"
    assert ours.data_folder == str(tmp_path / "a")
    assert (ours.data_name, ours.captions_per_image, ours.image_size,
            ours.tag_size) == (theirs.data_name, theirs.captions_per_image,
                               theirs.image_size, theirs.tag_size)
    assert_same_artifacts(tmp_path / "a", tmp_path / "b")


def test_preprocess_library_defaults_match_reference_cli():
    """tests/test_defaults_parity.py:17's counterpart."""
    sig = inspect.signature(preprocess.create_input_files)
    assert sig.parameters["max_len"].default == 50
    assert sig.parameters["tag_size"].default == 1000
    assert sig.parameters["image_size"].default == 256
    assert sig.parameters["workers"].default == 0


def test_preprocess_cli_defaults_match_reference_and_jax(tmp_path,
                                                         tiny_corpus,
                                                         capsys):
    """tests/test_defaults_parity.py:24's counterpart: -cpi 5, -mwf 5,
    -ml 50, --tag_size 1000, -w 0, the same flags as JAX's CLI; and the
    CLI writes the artifacts."""
    def spec(parser):
        return sorted((a.dest, tuple(a.option_strings), a.default, a.type)
                      for a in parser._actions if a.dest != "help")

    p = create_input_files.build_parser()
    assert spec(p) == spec(jax_cli.build_parser())
    d = {a.dest: a.default for a in p._actions}
    assert (d["captions_per_image"], d["min_word_freq"], d["max_len"],
            d["tag_size"], d["workers"]) == (5, 5, 50, 1000, 0)
    root, img_dir = tiny_corpus
    create_input_files.main(["-d", "flickr10k", "-s", str(root),
                             "-if", str(img_dir), "-of", str(tmp_path),
                             "-mwf", "0", "--tag_size", "4", "-w", "1"])
    assert "Input files created!" in capsys.readouterr().out
    assert (tmp_path / "WORDMAP_flickr10k_5_cap_per_img_0_min_word_freq"
            ".json").is_file()


def test_load_embeddings_matches_jax(tmp_path):
    """GloVe-format text (a word outside the map, a trailing newline and a
    double space): the rows of the file's words are its vectors, the
    others numpy's seeded draw, bitwise JAX's."""
    wm = {"<pad>": 0, "anjing": 1, "kucing": 2, "bola": 3, "<unk>": 4}
    lines = ["anjing 0.5 -1.25 3.0", "zebra 9 9 9", "bola 1e-3  2.5 -0.75"]
    path = tmp_path / "glove.txt"
    path.write_text("\n".join(lines) + "\n")
    for seed in (0, 7):
        ours, dim = embedding.load_embeddings(str(path), wm, seed=seed)
        theirs, jdim = jax_emb.load_embeddings(str(path), wm, seed=seed)
        assert dim == jdim == 3 and ours.dtype == np.float32
        np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(ours[1], np.float32([0.5, -1.25, 3.0]))
    np.testing.assert_array_equal(ours[3], np.float32([1e-3, 2.5, -0.75]))
    bound = math.sqrt(3.0 / 3)
    assert np.abs(ours[[0, 2, 4]]).max() <= bound
    np.testing.assert_array_equal(
        embedding.init_embedding(np.random.default_rng(1), (4, 6)),
        jax_emb.init_embedding(np.random.default_rng(1), (4, 6)))


def test_unigram_and_perplexity_hand_case():
    """tests/test_corpus_score.py's hand case, and JAX's functions."""
    corpus = [["a", "b", "a"], ["a", "c"]]
    counts = cs.unigram(corpus)
    assert counts == {"a": 3, "b": 1, "c": 1} == jax_cs.unigram(corpus)
    logp = 3 * math.log(3 / 5) + 2 * math.log(1 / 5)
    assert abs(cs.perplexity(corpus, counts) - math.exp(-logp / 5)) < 1e-12
    assert cs.perplexity(corpus, counts) == jax_cs.perplexity(corpus, counts)
    assert cs.prob_sentence(["a", "c"], counts) == jax_cs.prob_sentence(
        ["a", "c"], counts)


def test_prob_sentence_oov_is_neg_inf():
    counts = cs.unigram([["a"]])
    assert cs.prob_sentence(["zzz"], counts) == float("-inf")


def test_corpus_score_cli_end_to_end(tmp_path, capsys):
    """The five lines, equal to JAX's CLI's."""
    caps = ["anjing bermain bola", ["kucing", "di", "taman"],
            "anjing di taman"]
    f = tmp_path / "caps.json"
    f.write_text(json.dumps(caps))
    argv = ["--captions", str(f), "--min_word_freq", "1"]
    cs.main(argv)
    out = capsys.readouterr().out
    assert out.splitlines() == [
        "sentences: 3", "tokens: 9", "vocab: 6", "vocab (freq > 1): 3",
        out.splitlines()[-1]]
    assert out.splitlines()[-1].startswith("unigram perplexity: ")
    jax_cs.main(argv)
    assert capsys.readouterr().out == out
