"""Offline preprocessing: raw dataset -> HDF5/JSON training artifacts.

Counterpart of the JAX package's ``data/preprocess.py``: for the same
corpus it writes the same artifacts (every JSON file byte-equal; every
HDF5 dataset equal in shape, dtype and values, with the same attrs), in the
reference's names, shapes and dtypes (its utils/dataset.py:196-417):

  {split}_IMAGES_{base}.hdf5   dataset 'images' (N, 3, 256, 256) uint8,
                               attrs captions_per_image
  {split}_TAGS_{base}.hdf5     dataset 'tags' (N, tag_size) float32,
                               attrs tag_size
  {split}_CAPTIONS_{base}.json [[ids]] len = N * cpi, each max_len + 2
  {split}_CAPLENS_{base}.json  [int]
  {split}_RAWTAGS_{base}.json  [[tag strings]]
  WORDMAP_{base}.json / TAGMAP_{base}.json

Differences from the reference (deliberate, as in JAX's):
  * Pillow replaces the long-removed scipy.misc imread/imresize.
  * ``get_tags_en(..., tokenize=True)`` no longer shadows the nltk module.
  * Caption sampling uses a local ``random.Random(123)`` (the reference
    seeds the global RNG with 123 at utils/dataset.py:326: same sequence).

It runs on the CPU.  ``h5py``, Pillow and ``nltk`` are imported only inside
the functions that need them (the card's machine has none of h5py and
nltk).
"""

from __future__ import annotations

import json
import os
import random
from collections import Counter, deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Sequence

import numpy as np

from . import vocab as vocab_lib

ID_DATASETS = {"flickr10k", "coco_id", "flickr8k_id"}
ALL_DATASETS = ID_DATASETS | {"coco", "flickr30k", "flickr8k"}
NOUN_POS = {"NN", "NNP", "NNS", "NNPS"}


def get_ground_truth(tags: Sequence[str], tag_map: Dict[str, int],
                     tag_size: int) -> np.ndarray:
    """Multi-hot tag ground truth (utils/dataset.py:18-33)."""
    gt = np.zeros(tag_size, np.float32)
    for tag in tags:
        if tag in tag_map:
            gt[tag_map[tag]] = 1.0
    return gt


def get_tags_en(tokens_or_sentence, tokenize: bool = False) -> List[str]:
    """Lemmatised nouns of an English sentence (utils/dataset.py:36-42,
    minus its module-shadowing bug)."""
    from nltk import pos_tag, WordNetLemmatizer
    if tokenize:
        from nltk import tokenize as nltk_tokenize
        tokens = nltk_tokenize.word_tokenize(tokens_or_sentence)
    else:
        tokens = list(tokens_or_sentence)
    lemma = WordNetLemmatizer()
    tokens = [lemma.lemmatize(t) for t in tokens]
    return [w for w, pos in pos_tag(tokens) if pos in NOUN_POS]


def load_flickr10k(path_folder: str) -> dict:
    """Folder-format Indonesian Flickr dataset -> Karpathy-style dict
    (reference utils/dataset.py:65-176)."""
    def jload(name):
        with open(os.path.join(path_folder, name)) as f:
            return json.load(f)

    def lines(name):
        with open(os.path.join(path_folder, name)) as f:
            return [line.rstrip() for line in f.readlines()]

    filenames = jload("filenames.json")
    tags = jload("tags.json")
    captions = jload("captions.json")
    split_indexes = {s: set(lines(f"{s}.txt")) for s in ("train", "val", "test")}
    all_tags = lines("all_tags.txt")

    dataset = {"images": [], "dataset": "flickr10k", "all_tags": all_tags}
    for split in ("train", "val", "test"):
        for fname, caps, tag in zip(filenames, captions, tags):
            if fname.split(".")[0] not in split_indexes[split]:
                continue
            dataset["images"].append({
                "split": split,
                "filename": fname,
                "tags": tag,
                "sentences": [{"tokens": c.split(), "raw": c} for c in caps],
            })
    return dataset


def read_image(path: str, size: int = 256) -> np.ndarray:
    """Image file -> (3, size, size) uint8 CHW (the reference's HDF5 layout,
    utils/dataset.py:367-374), Pillow bilinear resize."""
    from PIL import Image
    img = Image.open(path)
    if img.mode != "RGB":
        img = img.convert("RGB")
    img = img.resize((size, size), Image.BILINEAR)
    return np.ascontiguousarray(np.asarray(img, np.uint8).transpose(2, 0, 1))


def _read_images_pipelined(paths: Sequence[str], image_size: int,
                           workers: int):
    """Yield decoded (3, S, S) uint8 images for ``paths`` IN ORDER,
    decoding up to ``workers`` images concurrently.

    Pillow releases the GIL during JPEG decode and resize, so a thread
    pool decodes in parallel.  A bounded in-flight window (2x workers)
    caps peak memory whatever the split's size; the consumer (HDF5 writes
    and the seeded caption sampling) stays on the calling thread, so the
    artifacts are the same for every worker count."""
    if workers <= 1:
        for p in paths:
            yield read_image(p, image_size)
        return
    with ThreadPoolExecutor(workers) as ex:
        window = 2 * workers
        pending = deque(ex.submit(read_image, p, image_size)
                        for p in paths[:window])
        nxt = len(pending)
        while pending:
            yield pending.popleft().result()
            if nxt < len(paths):
                pending.append(ex.submit(read_image, paths[nxt], image_size))
                nxt += 1


def create_input_files(dataset: str, split_path: str, image_folder: str,
                       captions_per_image: int, min_word_freq: int,
                       output_folder: str, tag_size: int = 1000,
                       max_len: int = 50,
                       image_size: int = 256,
                       workers: int = 0) -> Dict[str, str]:
    """Build all training artifacts; returns {artifact name: path}.

    ``workers``: concurrent image decoders for the per-split hot loop
    (0 = auto: ``os.cpu_count()``, 1 = sequential).  Output artifacts are
    identical for every worker count.
    """
    import h5py

    if workers <= 0:
        workers = os.cpu_count() or 1
    if dataset not in ALL_DATASETS:
        raise ValueError(f"dataset must be one of {sorted(ALL_DATASETS)}")
    os.makedirs(output_folder, exist_ok=True)

    if dataset == "flickr10k":
        data = load_flickr10k(split_path)
    else:
        with open(split_path) as f:
            data = json.load(f)

    is_id = dataset in ID_DATASETS
    word_freq: Counter = Counter()
    tag_freq: Counter = Counter()
    for img in data["images"]:
        for c in img["sentences"]:
            word_freq.update(c["tokens"])
            if not is_id:
                tag_freq.update(get_tags_en(c["tokens"]))

    if is_id:
        all_tags = list(data["all_tags"])
    else:
        all_tags = [t for t, _ in tag_freq.most_common(tag_size)]
    tag_map = {t: i for i, t in enumerate(all_tags)}

    splits: Dict[str, dict] = {s: {"paths": [], "captions": [], "tags": []}
                               for s in ("train", "val", "test")}
    for img in data["images"]:
        captions = []
        en_tags: List[str] = []
        for c in img["sentences"]:
            if len(c["tokens"]) <= max_len:
                captions.append(c["tokens"])
                if not is_id:
                    en_tags.extend(x for x in c["tokens"] if x in tag_map)
        if not captions:
            continue
        if dataset == "coco":
            path = os.path.join(image_folder, img["filepath"], img["filename"])
        else:
            path = os.path.join(image_folder, img["filename"])
        split = {"train": "train", "restval": "train", "val": "val",
                 "test": "test"}.get(img["split"])
        if split is None:
            continue
        splits[split]["paths"].append(path)
        splits[split]["captions"].append(captions)
        splits[split]["tags"].append(img["tags"] if is_id else en_tags)

    word_map = vocab_lib.build_word_map(word_freq, min_word_freq)
    base = vocab_lib.base_filename(dataset, captions_per_image, min_word_freq)
    outputs: Dict[str, str] = {}

    wm_path = vocab_lib.wordmap_path(output_folder, base)
    vocab_lib.save_json(word_map, wm_path)
    outputs["wordmap"] = wm_path
    tm_path = vocab_lib.tagmap_path(output_folder, base)
    vocab_lib.save_json(tag_map, tm_path)
    outputs["tagmap"] = tm_path

    rng = random.Random(123)  # sampling parity: utils/dataset.py:326
    for split_lower, split in (("train", "TRAIN"), ("val", "VAL"),
                               ("test", "TEST")):
        sp = splits[split_lower]
        n = len(sp["paths"])
        img_path = os.path.join(output_folder, f"{split}_IMAGES_{base}.hdf5")
        tag_path = os.path.join(output_folder, f"{split}_TAGS_{base}.hdf5")
        enc_captions: List[List[int]] = []
        caplens: List[int] = []
        with h5py.File(img_path, "w") as h, h5py.File(tag_path, "w") as t:
            h.attrs["captions_per_image"] = captions_per_image
            t.attrs["tag_size"] = tag_size
            images = h.create_dataset(
                "images", (n, 3, image_size, image_size), dtype="uint8")
            tags_ds = t.create_dataset("tags", (n, tag_size), dtype="float32")
            decoded = _read_images_pipelined(sp["paths"], image_size, workers)
            for i in range(n):
                caps = sp["captions"][i]
                if len(caps) < captions_per_image:
                    caps = caps + [rng.choice(caps) for _ in
                                   range(captions_per_image - len(caps))]
                else:
                    caps = rng.sample(caps, k=captions_per_image)
                images[i] = next(decoded)
                tags_ds[i] = get_ground_truth(sp["tags"][i], tag_map, tag_size)
                for c in caps:
                    ids, clen = vocab_lib.encode_caption(c, word_map, max_len)
                    enc_captions.append(ids)
                    caplens.append(clen)
        if not len(enc_captions) == len(caplens) == n * captions_per_image:
            raise AssertionError(f"{split}: {len(enc_captions)} captions for "
                                 f"{n} images at {captions_per_image} each")
        cap_path = os.path.join(output_folder, f"{split}_CAPTIONS_{base}.json")
        len_path = os.path.join(output_folder, f"{split}_CAPLENS_{base}.json")
        raw_path = os.path.join(output_folder, f"{split}_RAWTAGS_{base}.json")
        vocab_lib.save_json(enc_captions, cap_path)
        vocab_lib.save_json(caplens, len_path)
        vocab_lib.save_json(sp["tags"], raw_path)
        outputs[f"{split}_images"] = img_path
        outputs[f"{split}_tags"] = tag_path
        outputs[f"{split}_captions"] = cap_path
        outputs[f"{split}_caplens"] = len_path
        outputs[f"{split}_rawtags"] = raw_path
    return outputs
