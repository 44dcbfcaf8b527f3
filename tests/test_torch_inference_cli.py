"""The port's inference CLI against the JAX package's, on the CPU.

Counterparts of ``tests/test_examples.py:74 test_tagger_topk_example`` and
``:83 test_caption_and_visualize_example``, through ``cli/inference.run``
of both packages at the CLI's own widths (``ModelConfig()``: ResNet-152s at
256 px, dims 512, 1000 tags; a 50-word vocabulary): one seeded model,
BatchNorm calibrated on the image, written as the reference's serve-format
files that both CLIs read.  The top tags (names and order) and the caption
string must be equal, the probabilities within TAG_TOL, and both write the
attention PNG.  No URL is fetched.
"""

import json
import types

import numpy as np
import pytest
import torch
from PIL import Image

from indonesian_image_captioning_tpu.cli import inference as jax_inference
from indonesian_image_captioning_tpu.utils import url as jax_url
from indonesian_image_captioning_tpu_torch.cli import inference
from indonesian_image_captioning_tpu_torch.core.config import (BeamConfig,
                                                               ModelConfig,
                                                               TaggerConfig)
from indonesian_image_captioning_tpu_torch.data.preprocess import read_image
from indonesian_image_captioning_tpu_torch.models import (convert, decoders,
                                                          encoders)
from indonesian_image_captioning_tpu_torch.utils import url
from _torch_tmp import tmp_path_factory  # noqa: F401 (fixtures)

torch.set_num_threads(1)
# The tag probabilities of the two packages' ResNet-152 taggers: the
# encoders' eval-mode tolerance of tests/test_torch_encoders.py.  The two
# frameworks sum each convolution in another order, and 152 layers whose
# BatchNorm divides by statistics of one image carry that to about 5e-5.
TAG_TOL = 1e-4


@pytest.fixture(scope="module")
def cli_env(tmp_path_factory):
    root = tmp_path_factory.mktemp("inference")
    rng = np.random.default_rng(7)
    img = str(root / "image.png")
    Image.fromarray(rng.integers(0, 255, (64, 64, 3)).astype(np.uint8)
                    ).save(img)
    words = [f"w{i}" for i in range(46)] + ["<start>", "<end>", "<unk>"]
    word_map = {w: i + 1 for i, w in enumerate(words)}
    word_map["<pad>"] = 0
    wm_path = str(root / "WORDMAP.json")
    with open(wm_path, "w") as f:
        json.dump(word_map, f)
    cfg = ModelConfig(model_type="attention_scn", vocab_size=len(word_map))
    tm_path = str(root / "TAGMAP.json")
    with open(tm_path, "w") as f:
        json.dump({f"tag{i}": i for i in range(cfg.semantic_dim)}, f)

    gen = torch.Generator().manual_seed(3)
    params = decoders.init_decoder(gen, cfg)
    enc_p, enc_s = encoders.init_encoder_caption(gen)
    tag_p, tag_s = encoders.init_encoder_tagger(gen, TaggerConfig())
    # BatchNorm statistics from the image itself: random-init eval-mode
    # ResNet-152 features are about 1e10
    x = encoders.prep_images(torch.from_numpy(read_image(img)[None]))
    with torch.no_grad():
        _, enc_s = encoders.apply_encoder_caption(enc_p, enc_s, x,
                                                  train="calibrate")
        _, tag_s = encoders.apply_encoder_tagger(tag_p, tag_s, x,
                                                 train="calibrate")
    caption = str(root / "caption.pth.tar")
    tagger = str(root / "tagger.pth.tar")
    torch.save({"encoder_model_state_dict":
                convert.encoder_caption_to_torch(enc_p, enc_s),
                "decoder_model_state_dict":
                convert.decoder_to_torch(params, cfg)}, caption)
    torch.save({"model_state_dict":
                convert.encoder_tagger_to_torch(tag_p, tag_s)}, tagger)
    return dict(img=img, word_map=wm_path, tag_map=tm_path, caption=caption,
                tagger=tagger, root=root)


def argv(env, viz_out, beam="2"):
    return ["-t", "attention_scn", "-i", env["img"], "-mc", env["caption"],
            "-mt", env["tagger"], "-tm", env["tag_map"], "-wm",
            env["word_map"], "-b", beam, "--viz_out", viz_out]


def test_inference_cli_matches_jax(cli_env, capsys):
    ours_png = str(cli_env["root"] / "ours.png")
    theirs_png = str(cli_env["root"] / "theirs.png")
    ours = inference.run(inference.build_parser().parse_args(
        argv(cli_env, ours_png)), device="cpu")
    out = capsys.readouterr().out
    theirs = jax_inference.run(jax_inference.build_parser().parse_args(
        argv(cli_env, theirs_png)))
    assert "Predicted tags" in out and "Caption:" in out
    assert ours.keys() == theirs.keys() == {"image_path", "tags", "caption",
                                            "viz"}
    names = [n for n, _ in ours["tags"]]
    assert len(names) == 20 and names == [n for n, _ in theirs["tags"]]
    np.testing.assert_allclose([p for _, p in ours["tags"]],
                               [p for _, p in theirs["tags"]], rtol=0,
                               atol=TAG_TOL)
    assert ours["caption"] == theirs["caption"] and ours["caption"]
    assert ours["viz"] == ours_png and theirs["viz"] == theirs_png
    for png in (ours_png, theirs_png):
        with Image.open(png) as im:
            assert im.format == "PNG" and im.size[0] > 100


def test_caption_image_records_alphas(cli_env):
    """The middle of the CLI on a uint8 array: the "steps" rung, one alpha
    row per token, each after <start> summing to 1; the tag count honoured;
    the default device is the card."""
    with open(cli_env["word_map"]) as f:
        wm = json.load(f)
    cfg = ModelConfig(model_type="attention_scn", vocab_size=len(wm))
    from indonesian_image_captioning_tpu_torch.cli.common import \
        load_caption_state
    state = load_caption_state(cli_env["caption"], cfg, cli_env["tagger"],
                               device="cpu")
    got = inference.caption_image(
        state, cfg, read_image(cli_env["img"]), wm,
        beam_cfg=BeamConfig(beam_size=2), rev_tag_map={
            i: f"t{i}" for i in range(cfg.semantic_dim)}, tag_out_count=7,
        device="cpu")
    n = len(got["seq"])
    assert got["decode_impl"] == "steps" and len(got["tags"]) == 7
    assert got["seq"][0] == wm["<start>"]
    assert got["alphas"].shape == (n, cfg.num_pixels)
    np.testing.assert_allclose(got["alphas"][1:].sum(-1), 1.0, atol=1e-5)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            inference.caption_image(state, cfg, read_image(cli_env["img"]),
                                    wm)


def test_is_absolute_path_and_no_fetch_for_local_files(cli_env,
                                                       monkeypatch):
    for s in ("http://example.com/a.jpg", "https://x.org/p/q.png?s=1",
              "/tmp/a.jpg", "a.jpg", "file:///tmp/a.jpg", "C:/a.jpg", ""):
        assert url.is_absolute_path(s) == jax_url.is_absolute_path(s), s

    def no_fetch(*a, **kw):
        raise AssertionError("a local path was downloaded")

    monkeypatch.setattr(url, "download_file", no_fetch)
    seen = {}
    monkeypatch.setattr(inference, "load_caption_state",
                        lambda *a, **kw: seen.setdefault("state", None))
    monkeypatch.setattr(inference, "caption_image", lambda *a, **kw: {
        "caption": "w1", "seq": [47, 1, 48], "alphas": None,
        "decode_impl": "steps"})
    args = types.SimpleNamespace(
        img=cli_env["img"], word_map=cli_env["word_map"], type="pure_scn",
        model_caption="unused", model_tagger=None, tag_map=None,
        beam_size=1, tag_out_count=3, smooth=True, viz_out=None)
    assert inference.run(args, device="cpu") == {
        "image_path": cli_env["img"], "caption": "w1"}
