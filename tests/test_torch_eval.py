"""The port's TEST-split evaluation against the JAX package, on the CPU.

Counterpart of ``tests/test_metrics_eval.py::
test_eval_tagger_and_caption_end_to_end``: a corpus built by the JAX
``create_input_files``, one caption model and tagger (ResNet-50, narrow
decoder) drawn in JAX and carried across by ``models/jax_bridge.py``, with
BatchNorm statistics calibrated on the corpus by the port and carried back
(random-init eval-mode ResNet features are about 1e5 here).  Both packages'
``evaluate`` run on it: the tagger accuracies are equal, the hypotheses
equal token for token but where their first divergence is a near-tie
(prefix scores within 1e-4), the scores within 1e-6, the dump file names
and the transposed references equal.  Also the evaluation CLIs' flags,
``TagDataset``, a CPU rehearsal of ``chip_smoke.py``'s checkpoints and
evaluation phase, ``cli.eval_caption --mesh 2,2`` on four gloo ranks
(``tests/_torch_mesh_worker.py``) against JAX's ``evaluate(mesh_shape=(2,
2))`` (``tests/test_mesh_training.py:173``'s counterpart) and the port's
one-rank evaluation, and the multi-rank dry run
(``parallel/dryrun.run(4, 2)``).
"""

import functools
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from indonesian_image_captioning_tpu.cli import eval_caption as jax_cli_cap
from indonesian_image_captioning_tpu.cli import eval_tagger as jax_cli_tag
from indonesian_image_captioning_tpu.cli import inference as jax_cli_inf
from indonesian_image_captioning_tpu.core.config import (
    BeamConfig as JaxBeamConfig, DataConfig as JaxDataConfig,
    ModelConfig as JaxModelConfig)
from indonesian_image_captioning_tpu.core.prng import root_key
from indonesian_image_captioning_tpu.data import datasets as jax_datasets
from indonesian_image_captioning_tpu.data import preprocess
from indonesian_image_captioning_tpu.evaluation import \
    eval_caption as jax_eval_caption
from indonesian_image_captioning_tpu.evaluation import \
    eval_tagger as jax_eval_tagger
from indonesian_image_captioning_tpu.train import caption as jax_caption
from indonesian_image_captioning_tpu.train import steps as jax_steps
from indonesian_image_captioning_tpu_torch.cli import eval_caption as cli_cap
from indonesian_image_captioning_tpu_torch.cli import eval_tagger as cli_tag
from indonesian_image_captioning_tpu_torch.cli import inference as cli_inf
from indonesian_image_captioning_tpu_torch.core import checkpoint as ckpt
from indonesian_image_captioning_tpu_torch.core.config import (BeamConfig,
                                                               DataConfig,
                                                               ModelConfig)
from indonesian_image_captioning_tpu_torch.data import loader, vocab
from indonesian_image_captioning_tpu_torch.data.datasets import (
    CaptionDataset, TagDataset)
from indonesian_image_captioning_tpu_torch.evaluation import (eval_caption,
                                                              eval_tagger)
from indonesian_image_captioning_tpu_torch.models import encoders
from indonesian_image_captioning_tpu_torch.models.jax_bridge import (
    params_from_jax, params_to_jax)
from _torch_tmp import tmp_path, tmp_path_factory  # noqa: F401 (fixtures)

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
NAME = "flickr10k_2_cap_per_img_0_min_word_freq"
CFG = dict(model_type="attention_scn", embed_dim=16, attention_dim=16,
           decoder_dim=16, factored_dim=12, semantic_dim=4, enc_image_size=2,
           max_caption_len=12, encoder_arch="resnet50")
BEAM = dict(beam_size=3, max_steps=11)
WORDS = ("kucing bermain bola di taman anjing tidur rumput merah biru "
         "seekor dua orang berlari").split()


def chip_smoke():
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    import chip_smoke
    return chip_smoke


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A flickr10k-layout corpus of 9 images (TEST 5) through the JAX
    create_input_files, and one model on it: (data folder, word map,
    port state, JAX state)."""
    root = tmp_path_factory.mktemp("eval")
    img_dir = root / "corpus" / "imgs"
    img_dir.mkdir(parents=True)
    rng = np.random.default_rng(0)
    filenames, captions, tags = [], [], []
    for i in range(9):
        name = f"{i:04d}.jpg"
        Image.fromarray(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
                        ).save(img_dir / name)
        filenames.append(name)
        captions.append([" ".join(rng.choice(WORDS, rng.integers(2, 7)))
                         for _ in range(2)])
        tags.append([str(t) for t in rng.choice(["kucing", "anjing",
                                                 "taman", "bola"], 2)])
    meta = root / "corpus"
    (meta / "filenames.json").write_text(json.dumps(filenames))
    (meta / "captions.json").write_text(json.dumps(captions))
    (meta / "tags.json").write_text(json.dumps(tags))
    (meta / "train.txt").write_text("0000\n0001\n0002")
    (meta / "val.txt").write_text("0003")
    (meta / "test.txt").write_text("0004\n0005\n0006\n0007\n0008")
    (meta / "all_tags.txt").write_text("kucing\nanjing\ntaman\nbola")
    out = root / "scn"
    preprocess.create_input_files("flickr10k", str(meta), str(img_dir), 2,
                                  0, str(out), tag_size=4, max_len=10,
                                  image_size=32)
    wm = vocab.load_json(vocab.wordmap_path(str(out), NAME))

    jcfg = JaxModelConfig(vocab_size=len(wm), **CFG)
    jstate = jax_caption.init_state(root_key(0), jcfg,
                                    jax_steps.make_optimizer(4e-4, 5.0))
    state = {k: params_from_jax(jstate[k]) for k in (
        "params", "encoder", "encoder_stats", "tagger", "tagger_stats")}
    x = encoders.prep_images(torch.from_numpy(
        CaptionDataset(str(out), NAME, "TEST").gather_images(np.arange(5))))
    for name, apply in (("encoder", encoders.apply_encoder_caption),
                        ("tagger", encoders.apply_encoder_tagger)):
        _, stats = apply(state[name], state[name + "_stats"], x,
                         train="calibrate", arch="resnet50")
        state[name + "_stats"] = stats
        jstate[name + "_stats"] = params_to_jax(stats)
    return str(out), wm, state, jstate


def prefix_gap(state, cfg, ds, img, a, b, wm):
    """|score difference| of two word sequences' common-length prefixes up
    to their first divergence, for image ``img`` (the plain step engine)."""
    cs = chip_smoke()
    with torch.no_grad():
        x = encoders.prep_images(torch.from_numpy(
            ds.gather_images(np.array([img]))))
        enc = encoders.apply_encoder_caption(
            state["encoder"], state["encoder_stats"], x,
            enc_image_size=cfg.enc_image_size, arch=cfg.encoder_arch)[0]
        tags = encoders.apply_encoder_tagger(
            state["tagger"], state["tagger_stats"], x,
            arch=cfg.encoder_arch)[0]
        ids = [[wm["<start>"]] + [wm[w] for w in s] + [wm["<end>"]]
               for s in (a, b)]
        t = next(i for i, (p, q) in enumerate(zip(*ids)) if p != q) \
            if any(p != q for p, q in zip(*ids)) else min(map(len, ids)) - 1
        L = max(map(len, ids))
        seqs = torch.tensor([s + [0] * (L - len(s)) for s in ids])
        sc = cs.prefix_scores(state["params"], cfg, enc, tags, seqs, t)
    return abs(float(sc[0] - sc[1]))


def test_eval_tagger_and_caption_match_jax(corpus, tmp_path):
    folder, wm, state, jstate = corpus
    cfg = ModelConfig(vocab_size=len(wm), **CFG)
    jcfg = JaxModelConfig(vocab_size=len(wm), **CFG)
    ours_root, theirs_root = tmp_path / "ours", tmp_path / "theirs"
    scores = eval_caption.evaluate(
        state, cfg, DataConfig(data_folder=folder, data_name=NAME), wm,
        beam_cfg=BeamConfig(**BEAM), batch_size=2,
        output_root=str(ours_root), log=lambda s: None, device="cpu")
    jscores = jax_eval_caption.evaluate(
        jstate, jcfg, JaxDataConfig(data_folder=folder, data_name=NAME), wm,
        beam_cfg=JaxBeamConfig(**BEAM), batch_size=2,
        output_root=str(theirs_root), log=lambda s: None)
    (ours,), (theirs,) = ours_root.iterdir(), theirs_root.iterdir()
    names = sorted(p.name for p in ours.iterdir())
    assert names == sorted(p.name for p in theirs.iterdir()) == [
        f"attention_scn_beam_3_{k}.json"
        for k in ("hypotheses", "references", "scores")]

    def load(d, kind):
        return json.loads((d / f"attention_scn_beam_3_{kind}.json")
                          .read_text())

    refs = load(ours, "references")
    assert refs == load(theirs, "references")
    assert len(refs) == 2 and len(refs[0]) == 5      # cpi x images
    hyps, jhyps = load(ours, "hypotheses"), load(theirs, "hypotheses")
    assert len(hyps) == len(jhyps) == 5
    ds = CaptionDataset(folder, NAME, "TEST")
    for i, (a, b) in enumerate(zip(hyps, jhyps)):
        if a != b:
            gap = prefix_gap(state, cfg, ds, i, a.split(), b.split(), wm)
            assert gap <= 1e-4, (i, a, b, gap)
    assert load(ours, "scores") == scores
    assert scores.keys() == jscores.keys() and "METEOR" in scores
    for k in scores:
        assert abs(scores[k] - jscores[k]) <= 1e-6, k

    acc = eval_tagger.evaluate(state["tagger"], state["tagger_stats"],
                               DataConfig(data_folder=folder,
                                          data_name=NAME),
                               batch_size=2, arch="resnet50",
                               log=lambda s: None, device="cpu")
    jacc = jax_eval_tagger.evaluate(jstate["tagger"], jstate["tagger_stats"],
                                    JaxDataConfig(data_folder=folder,
                                                  data_name=NAME),
                                    batch_size=2, arch="resnet50",
                                    log=lambda s: None)
    assert acc == jacc and 0.0 <= acc <= 100.0


def test_decode_dataset_takes_an_in_memory_split(corpus):
    """The seam the card uses: decode_dataset on CaptionDataset.from_arrays
    gives what evaluate's HDF5 split gives; one shape for every batch."""
    folder, wm, state, _ = corpus
    cfg = ModelConfig(vocab_size=len(wm), **CFG)
    ds = CaptionDataset(folder, NAME, "TEST")
    mem = CaptionDataset.from_arrays(ds.gather_images(np.arange(5)),
                                     ds.captions, ds.caplens, cpi=ds.cpi,
                                     split="TEST")
    kw = dict(beam_cfg=BeamConfig(**BEAM), batch_size=2, log=lambda s: None,
              device="cpu")
    assert eval_caption.decode_dataset(state, cfg, ds, wm, **kw) == \
        eval_caption.decode_dataset(state, cfg, mem, wm, **kw)


def parser_spec(parser):
    return sorted((a.dest, tuple(a.option_strings), a.default, a.nargs,
                   a.const, tuple(a.choices or ()), a.type)
                  for a in parser._actions if a.dest != "help")


def test_clis_parse_the_jax_flags_and_run(corpus, tmp_path, monkeypatch):
    """eval_caption, eval_tagger and inference take JAX's flags and
    defaults; the evaluation CLIs run on the port's own checkpoint files;
    --mesh without a process group of its size raises before any
    loading, and so does evaluate's mesh_shape."""
    for ours, theirs in ((cli_cap, jax_cli_cap), (cli_tag, jax_cli_tag),
                         (cli_inf, jax_cli_inf)):
        assert parser_spec(ours.build_parser()) == \
            parser_spec(theirs.build_parser())
    with pytest.raises(ValueError, match="process group has 1"):
        cli_cap.main(["-t", "attention_scn", "-mc", "missing.pth",
                      "--mesh", "2,1"], device="cpu")
    folder, wm, state, _ = corpus
    cfg = ModelConfig(vocab_size=len(wm), **CFG)
    data_cfg = DataConfig(data_folder=folder, data_name=NAME)
    with pytest.raises(ValueError, match="process group has 1"):
        eval_caption.evaluate(state, cfg, data_cfg, wm, mesh_shape=(2, 2),
                              device="cpu")

    caption_file = ckpt.save_checkpoint(
        str(tmp_path), "attention_scn", NAME,
        {"state": state, "epoch": 0, "epochs_since_improvement": 0,
         "metric": 0.0}, is_best=False)
    tagger_file = str(tmp_path / "checkpoint_tagger")
    ckpt.save_pytree(tagger_file, {"state": {
        "params": state["tagger"], "stats": state["tagger_stats"]}})
    # the CLIs build the reference's widths (ModelConfig(), a ResNet-152
    # tagger): give them this corpus's narrow model
    monkeypatch.setattr(cli_cap, "ModelConfig",
                        lambda **kw: ModelConfig(**{**CFG, **kw}))
    monkeypatch.setattr(eval_tagger, "evaluate", functools.partial(
        eval_tagger.evaluate, arch="resnet50", log=lambda s: None))
    got = cli_cap.main(["-t", "attention_scn", "-mc", caption_file,
                        "-df", folder, "-dn", NAME, "-bs", "3",
                        "--batch_size", "2", "--output_root",
                        str(tmp_path / "cli_out")], device="cpu")
    assert got == eval_caption.evaluate(
        state, cfg, data_cfg, wm, beam_cfg=BeamConfig(beam_size=3),
        batch_size=2, output_root=None, log=lambda s: None, device="cpu")
    acc = cli_tag.main(["-mt", tagger_file, "-df", folder, "-dn", NAME,
                        "-bs", "2"], device="cpu")
    assert acc == eval_tagger.evaluate(state["tagger"],
                                       state["tagger_stats"], data_cfg,
                                       batch_size=2, device="cpu")


def test_tag_dataset_matches_jax(corpus):
    folder = corpus[0]
    for split in ("TRAIN", "TEST"):
        ours = TagDataset(folder, NAME, split)
        theirs = jax_datasets.TagDataset(folder, NAME, split)
        mem = TagDataset.from_arrays(ours.gather_images(
            np.arange(ours.num_images)), ours.tags, split=split)
        assert len(ours) == len(theirs) == len(mem)
        assert ours.num_images == theirs.num_images == mem.num_images
        assert ours.tag_size == theirs.tag_size == mem.tag_size == 4
        for a, b, c in zip(loader.iterate(ours, 2), loader.iterate(theirs, 2),
                           loader.iterate(mem, 2)):
            assert a.keys() == b.keys() == c.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], np.asarray(b[k]))
                np.testing.assert_array_equal(a[k], c[k])
    with pytest.raises(ValueError):
        TagDataset.from_arrays(np.zeros((2, 3, 4, 4), np.float32),
                               np.zeros((2, 4)))
    with pytest.raises(ValueError):
        TagDataset.from_arrays(np.zeros((2, 3, 4, 4), np.uint8),
                               np.zeros((3, 4)))


def test_chip_smoke_checkpoints_and_evaluation_phase_on_cpu():
    """The card's checkpoints-and-evaluation phase rehearsed at narrow
    widths: its three families written and loaded bitwise, the in-memory
    TEST split decoded and scored, the tagger's accuracy against the
    plain computation, inference on a uint8 array (its launch checks need
    the card and are not made here)."""
    cs = chip_smoke()
    cfg = ModelConfig(vocab_size=40, **{**CFG, "semantic_dim": 24})
    cs.checkpoints_and_evaluation(torch.device("cpu"), cfg, 64, n_images=5,
                                  batch=2)


def test_eval_cli_on_mesh_matches_jax_and_one_rank(corpus, tmp_path):
    """cli.eval_caption --mesh 2,2 on four ranks (one image of every batch
    of two a data row, the model ranks repeating it): its hypotheses equal
    the port's one-rank evaluation's at one image a batch, token for
    token, and JAX's evaluate(mesh_shape=(2, 2))'s but where their first
    divergence is a near-tie (prefix scores within 1e-4); rank 0 alone
    writes the dumps, and the scores are the dump's on every rank."""
    from test_torch_mesh import launch
    folder, wm, state, jstate = corpus
    cfg = ModelConfig(vocab_size=len(wm), **CFG)
    caption_file = ckpt.save_checkpoint(
        str(tmp_path), "attention_scn", NAME,
        {"state": state, "epoch": 0, "epochs_since_improvement": 0,
         "metric": 0.0}, is_best=False)
    out_root = tmp_path / "mesh_out"
    argv = ["-t", "attention_scn", "-mc", caption_file, "-df", folder, "-dn",
            NAME, "-bs", "3", "--batch_size", "2", "--output_root",
            str(out_root), "--mesh", "2,2"]
    ranks = launch(tmp_path, {"cases": [dict(case="eval_cli", cfg=CFG,
                                             argv=argv)],
                              "mesh": (2, 2)}, n=4)
    (run,) = out_root.iterdir()
    hyps = json.loads((run / "attention_scn_beam_3_hypotheses.json")
                      .read_text())
    scores = json.loads((run / "attention_scn_beam_3_scores.json")
                        .read_text())
    assert all(r[0]["scores"] == scores for r in ranks)

    one_root = tmp_path / "one_out"
    eval_caption.evaluate(state, cfg, DataConfig(data_folder=folder,
                                                 data_name=NAME), wm,
                          beam_cfg=BeamConfig(beam_size=3), batch_size=1,
                          output_root=str(one_root), log=lambda s: None,
                          device="cpu")
    (one,) = one_root.iterdir()
    assert hyps == json.loads((one / "attention_scn_beam_3_hypotheses.json")
                              .read_text())

    jroot = tmp_path / "jax_out"
    jax_eval_caption.evaluate(
        jstate, JaxModelConfig(vocab_size=len(wm), **CFG),
        JaxDataConfig(data_folder=folder, data_name=NAME), wm,
        beam_cfg=JaxBeamConfig(beam_size=3), batch_size=2,
        output_root=str(jroot), mesh_shape=(2, 2), log=lambda s: None)
    (theirs,) = jroot.iterdir()
    jhyps = json.loads((theirs / "attention_scn_beam_3_hypotheses.json")
                       .read_text())
    assert len(hyps) == len(jhyps) == 5
    ds = CaptionDataset(folder, NAME, "TEST")
    for i, (a, b) in enumerate(zip(hyps, jhyps)):
        if a != b:
            gap = prefix_gap(state, cfg, ds, i, a.split(), b.split(), wm)
            assert gap <= 1e-4, (i, a, b, gap)


def test_dryrun_on_four_ranks():
    """parallel/dryrun.run(4, 2): one epoch of vocab-sharded training at
    (2, 2) from the artifact files, the mesh evaluation and a serve smoke
    on the gathered state, on four gloo ranks on the CPU."""
    from indonesian_image_captioning_tpu_torch.parallel import dryrun
    loss = dryrun.run(4, 2, device="cpu")
    assert np.isfinite(loss) and loss > 0
