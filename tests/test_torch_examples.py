"""The port's examples (``indonesian_image_captioning_tpu_torch/examples``)
on the CPU: counterparts of ``tests/test_examples.py:74
test_tagger_topk_example`` and ``:83 test_caption_and_visualize_example``.

Flagship widths (``ModelConfig()``: ResNet-152s at 256 px, 1000 tags) with
seeded weights, BatchNorm statistics calibrated on the image, written as
the port's own checkpoint files; a local PNG, no URL.  The tag table must
be the tagger's top-k in ``np.argsort(-probs)`` order, and the caption
example must print the caption and write the attention PNG.
"""

import json

import numpy as np
import pytest
import torch
from PIL import Image

from indonesian_image_captioning_tpu_torch.core.config import (ModelConfig,
                                                               TaggerConfig)
from indonesian_image_captioning_tpu_torch.data.preprocess import read_image
from indonesian_image_captioning_tpu_torch.examples import (
    caption_and_visualize, tagger_topk)
from indonesian_image_captioning_tpu_torch.models import decoders, encoders

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def example_env(tmp_path_factory):
    root = tmp_path_factory.mktemp("examples")
    rng = np.random.default_rng(7)
    img = str(root / "image.png")
    Image.fromarray(rng.integers(0, 255, (64, 64, 3)).astype(np.uint8)
                    ).save(img)
    words = [f"w{i}" for i in range(46)] + ["<start>", "<end>", "<unk>"]
    word_map = {w: i + 1 for i, w in enumerate(words)}
    word_map["<pad>"] = 0
    cfg = ModelConfig(model_type="attention_scn", vocab_size=len(word_map))
    paths = {k: str(root / f"{k}.json") for k in ("word_map", "tag_map")}
    for k, obj in (("word_map", word_map),
                   ("tag_map", {f"tag{i}": i
                                for i in range(cfg.semantic_dim)})):
        with open(paths[k], "w") as f:
            json.dump(obj, f)
    gen = torch.Generator().manual_seed(3)
    params = decoders.init_decoder(gen, cfg)
    enc_p, enc_s = encoders.init_encoder_caption(gen)
    tag_p, tag_s = encoders.init_encoder_tagger(gen, TaggerConfig())
    x = encoders.prep_images(torch.from_numpy(read_image(img)[None]))
    with torch.no_grad():
        _, enc_s = encoders.apply_encoder_caption(enc_p, enc_s, x,
                                                  train="calibrate")
        _, tag_s = encoders.apply_encoder_tagger(tag_p, tag_s, x,
                                                 train="calibrate")
        probs = encoders.apply_encoder_tagger(tag_p, tag_s, x)[0][0]
    paths["tagger"] = str(root / "tagger.pt")
    torch.save({"state": {"params": tag_p, "stats": tag_s}},
               paths["tagger"])
    paths["caption"] = str(root / "caption.pt")
    # the caption file holds no tagger: -mt supplies it
    torch.save({"state": {"params": params, "encoder": enc_p,
                          "encoder_stats": enc_s}}, paths["caption"])
    return dict(img=img, probs=probs.numpy(), **paths)


def test_tagger_topk_example(example_env, capsys):
    top = tagger_topk.main(["--img", example_env["img"],
                            "--model_tagger", example_env["tagger"],
                            "--tag_map", example_env["tag_map"],
                            "--topk", "5"], device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].split() == ["tag", "prob"] and len(lines) == 6
    want = np.argsort(-example_env["probs"])[:5]
    assert [name for name, _ in top] == [f"tag{i}" for i in want]
    np.testing.assert_allclose([p for _, p in top],
                               example_env["probs"][want], rtol=0,
                               atol=1e-6)
    assert lines[1].split()[0] == f"tag{want[0]}"


def test_caption_and_visualize_example(example_env, capsys, tmp_path):
    viz_out = str(tmp_path / "att.png")
    result = caption_and_visualize.main(
        ["-t", "attention_scn", "-i", example_env["img"],
         "-mc", example_env["caption"], "-mt", example_env["tagger"],
         "-tm", example_env["tag_map"], "-wm", example_env["word_map"],
         "-b", "2", "--viz_out", viz_out], device="cpu")
    out = capsys.readouterr().out
    assert "Caption:" in out and "result:" in out
    assert result["viz"] == viz_out
    assert Image.open(viz_out).size[0] > 0    # the attention grid PNG
