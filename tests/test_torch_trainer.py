"""The port's caption-trainer harness against the JAX package, on the CPU.

The corpus is ``tests/test_train_smoke.py``'s (8 noise images, 2 captions
each, built with the JAX package's ``preprocess.create_input_files``).
The dataset rows, batch order and masks, BLEU-4 and the feature cache's
rows must be equal; ``caption.main`` on ``attention_scn`` at the smoke
test's widths, dropout 0, with the JAX ``init_state`` weights bridged in,
must give JAX's ``train_loss`` within 1e-4 relative and its BLEU-4 within
1e-12 relative.  Both trainers run their frozen encoders in float32
(``encoder_dtype="float32"``): the comparison is of the algorithm, and
JAX's bfloat16 encoders round at other places than the port's.
"""

import dataclasses
import json
import os
import threading

import numpy as np
import pytest
import torch
from PIL import Image

from indonesian_image_captioning_tpu.cli import train as jax_cli
from indonesian_image_captioning_tpu.core.config import \
    DataConfig as JaxDataConfig
from indonesian_image_captioning_tpu.core.config import \
    ModelConfig as JaxModelConfig
from indonesian_image_captioning_tpu.core.config import \
    TrainConfig as JaxTrainConfig
from indonesian_image_captioning_tpu.data import datasets as jax_datasets
from indonesian_image_captioning_tpu.data import loader as jax_loader
from indonesian_image_captioning_tpu.data import preprocess
from indonesian_image_captioning_tpu_torch.cli import train as cli
from indonesian_image_captioning_tpu_torch.core import checkpoint as ckpt
from indonesian_image_captioning_tpu_torch.core.config import (DataConfig,
                                                               ModelConfig,
                                                               TrainConfig)
from indonesian_image_captioning_tpu_torch.data import loader
from indonesian_image_captioning_tpu_torch.data.datasets import \
    CaptionDataset
from indonesian_image_captioning_tpu_torch.models import encoders
from indonesian_image_captioning_tpu_torch.models.jax_bridge import \
    params_from_jax
from indonesian_image_captioning_tpu_torch.train import (caption,
                                                         feature_cache,
                                                         steps)
from _torch_tmp import tmp_path, tmp_path_factory  # noqa: F401 (fixtures)

torch.set_num_threads(1)
CPU = torch.device("cpu")
NAME = "flickr10k_2_cap_per_img_0_min_word_freq"


@pytest.fixture(scope="module")
def data_env(tmp_path_factory):
    """tests/test_train_smoke.py's corpus, preprocessed by the JAX
    package."""
    root = tmp_path_factory.mktemp("corpus")
    img_dir = root / "imgs"
    img_dir.mkdir()
    out = tmp_path_factory.mktemp("scn_data")
    rng = np.random.default_rng(0)
    words = ["anjing", "kucing", "bermain", "di", "taman", "bola", "anak"]
    filenames, captions, tags = [], [], []
    for i in range(8):
        name = f"{i:04d}.jpg"
        Image.fromarray(rng.integers(0, 256, (40, 40, 3), dtype=np.uint8)
                        ).save(img_dir / name)
        filenames.append(name)
        captions.append([" ".join(rng.choice(words, 4).tolist())
                         for _ in range(2)])
        tags.append([rng.choice(["anjing", "kucing"])])
    (root / "filenames.json").write_text(json.dumps(filenames))
    (root / "captions.json").write_text(json.dumps(captions))
    (root / "tags.json").write_text(json.dumps(tags))
    (root / "train.txt").write_text("\n".join(f"{i:04d}" for i in range(6)))
    (root / "val.txt").write_text("\n".join(f"{i:04d}" for i in range(6, 8)))
    (root / "test.txt").write_text("")
    (root / "all_tags.txt").write_text("anjing\nkucing")
    preprocess.create_input_files(
        "flickr10k", str(root), str(img_dir), captions_per_image=2,
        min_word_freq=0, output_folder=str(out), tag_size=2, max_len=10,
        image_size=32)
    return str(out)


def model_kw(vocab_size, **kw):
    return dict(model_type="attention_scn", vocab_size=vocab_size,
                embed_dim=16, attention_dim=16, decoder_dim=16,
                factored_dim=12, semantic_dim=2, enc_image_size=2,
                max_caption_len=12, encoder_arch="resnet50", dropout=0.0,
                **kw)


def train_kw(checkpoint_dir, **kw):
    return dict(epochs=2, batch_size=4, print_freq=1,
                checkpoint_dir=str(checkpoint_dir), encoder_dtype="float32",
                **kw)


def word_map(folder):
    with open(os.path.join(folder, f"WORDMAP_{NAME}.json")) as f:
        return json.load(f)


def assert_batches_equal(ours, theirs):
    assert sorted(ours) == sorted(theirs)
    for k in theirs:
        a, b = np.asarray(ours[k]), np.asarray(theirs[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("split", ["TRAIN", "VAL"])
def test_dataset_rows_match_jax(data_env, split):
    ours = CaptionDataset(data_env, NAME, split)
    theirs = jax_datasets.CaptionDataset(data_env, NAME, split)
    assert (len(ours), ours.num_images, ours.cpi) == (
        len(theirs), theirs.num_images, theirs.cpi)
    idx = np.array([3, 0, 3, len(ours) - 1])
    assert_batches_equal(ours.gather(idx), theirs.gather(idx))
    np.testing.assert_array_equal(ours.gather_images(np.array([1, 0])),
                                  theirs.gather_images(np.array([1, 0])))
    mem = CaptionDataset.from_arrays(
        ours._images, ours.captions, ours.caplens, cpi=ours.cpi,
        tags=ours.tags, split=split)
    assert_batches_equal(mem.gather(idx), ours.gather(idx))
    ours.load_images = theirs.load_images = False
    assert_batches_equal(ours.gather(idx), theirs.gather(idx))
    with pytest.raises(ValueError):
        CaptionDataset.from_arrays(ours._images, ours.captions[:-1],
                                   ours.caplens[:-1], cpi=ours.cpi)


@pytest.mark.parametrize("shuffle,epoch,drop_last,with_index", [
    (False, 0, False, False), (True, 3, False, True), (True, 1, True, True)])
def test_iterate_matches_jax(data_env, shuffle, epoch, drop_last,
                             with_index):
    ds = CaptionDataset(data_env, NAME, "VAL")
    jds = jax_datasets.CaptionDataset(data_env, NAME, "VAL")
    kw = dict(shuffle=shuffle, seed=7, epoch=epoch, drop_last=drop_last,
              with_index=with_index)
    ours = list(loader.iterate(ds, 3, **kw))
    theirs = list(jax_loader.iterate(jds, 3, **kw))
    assert len(ours) == len(theirs) == loader.num_batches(
        len(ds), 3, drop_last) == jax_loader.num_batches(len(ds), 3,
                                                         drop_last)
    for a, b in zip(ours, theirs):
        assert_batches_equal(a, b)
    # a data-parallel rank's block of every global batch is JAX's process
    # slice
    for rank in range(2):
        ours = list(loader.iterate(ds, 4, process_index=rank,
                                   process_count=2, **kw))
        theirs = list(jax_loader.iterate(jds, 4, process_index=rank,
                                         process_count=2, **kw))
        assert len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            assert_batches_equal(a, b)


def test_prefetch_yields_the_batches_and_stops(data_env):
    ds = CaptionDataset(data_env, NAME, "TRAIN")
    host = list(loader.iterate(ds, 4, shuffle=True, seed=1, with_index=True))
    got = list(loader.prefetch_to_device(
        loader.iterate(ds, 4, shuffle=True, seed=1, with_index=True), CPU))
    assert len(got) == len(host)
    for a, b in zip(got, host):
        assert all(torch.is_tensor(v) and v.device == CPU
                   for v in a.values())
        assert_batches_equal({k: v.numpy() for k, v in a.items()}, b)

    def failing():
        yield from loader.iterate(ds, 4)
        raise OSError("disk gone")

    with pytest.raises(OSError, match="disk gone"):
        list(loader.prefetch_to_device(failing(), CPU))
    before = threading.active_count()
    it = loader.prefetch_to_device(loader.iterate(ds, 1), CPU, size=1)
    next(it)
    it.close()             # a consumer that stops early frees the worker
    assert threading.active_count() == before


def test_bleu_gate_matches_jax():
    """The port's pure-Python BLEU-4 equals the JAX trainer's nltk call,
    also where only lower-order n-grams match (a tiny positive score)."""
    import warnings
    from indonesian_image_captioning_tpu.train import caption as jax_caption
    rng = np.random.default_rng(0)
    for trial in range(40):
        n = int(rng.integers(1, 6))
        refs = [[rng.integers(0, 12, rng.integers(1, 9)).tolist()
                 for _ in range(int(rng.integers(1, 4)))] for _ in range(n)]
        hyps = [rng.integers(0, 12, rng.integers(0, 9)).tolist()
                for _ in range(n)]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            try:
                theirs = jax_caption.bleu4_from_batches(refs, hyps)
            except ZeroDivisionError:
                theirs = 0.0
        ours = caption.bleu4_from_batches(refs, hyps)
        assert ours == pytest.approx(theirs, rel=1e-12, abs=0.0), trial


def leaves(tree):
    """The tensors of a nested dict or list, in order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def small_state(cfg, seed=0):
    gen = torch.Generator().manual_seed(seed)
    opt = steps.make_optimizer(1e-2, 5.0)
    state = caption.init_state(gen, cfg, opt, device=CPU)
    return state, opt


def test_checkpoint_async_save_best_and_resume(tmp_path):
    cfg = ModelConfig(**model_kw(30))
    state, opt = small_state(cfg)
    for p in steps.tree_leaves(state["params"]):
        p.grad = torch.randn(p.shape, generator=torch.Generator()
                             .manual_seed(1))
    opt.update(state["opt_state"])
    expect = [p.detach().clone() for p in steps.tree_leaves(state["params"])]
    moments = [s["exp_avg"].clone()
               for s in state["opt_state"].state.values()]
    saver = ckpt.AsyncSaver()
    saver.submit(str(tmp_path), "attention_scn", "d", {
        "state": steps.state_payload(state), "epoch": 4,
        "epochs_since_improvement": 1, "metric": 0.25}, True)
    with torch.no_grad():     # the next step updates in place
        for p in steps.tree_leaves(state["params"]):
            p.add_(1.0)
    saver.wait()
    saver.close()
    assert (tmp_path / "checkpoint_attention_scn_d").is_file()
    assert (tmp_path / "BEST_checkpoint_attention_scn_d").is_file()
    for best in (False, True):
        payload = ckpt.load_checkpoint(str(tmp_path), "attention_scn", "d",
                                       best=best)
        assert (payload["epoch"], payload["epochs_since_improvement"],
                payload["metric"]) == (4, 1, 0.25)
        fresh, _ = small_state(cfg, seed=5)
        steps.restore_state(fresh, payload["state"],
                            params=("params", "encoder"))
        for i, p in enumerate(steps.tree_leaves(fresh["params"])):
            assert torch.equal(p, expect[i])
        got = [s["exp_avg"] for s in fresh["opt_state"].state.values()]
        assert all(torch.equal(a, b) for a, b in zip(got, moments))
        assert int(next(iter(fresh["opt_state"].state.values()))["step"]) \
            == 1
        for k in ("encoder", "encoder_stats", "tagger", "tagger_stats"):
            assert all(torch.equal(a, b) for a, b in
                       zip(leaves(fresh[k]), leaves(state[k])))


def test_feature_cache_rows_equal_the_encoders(data_env):
    ds = CaptionDataset(data_env, NAME, "TRAIN")
    cfg = ModelConfig(**model_kw(30))
    tcfg = TrainConfig(**train_kw("."))
    state, _ = small_state(cfg)
    encode = steps.make_encoders_fn(cfg, tcfg.encoder_dtype, CPU)
    caches = {host: feature_cache.build(state, cfg, tcfg, ds, device=CPU,
                                        force_host=host, log=lambda s: None)
              for host in (False, True)}
    assert caches[False].on_device and not caches[True].on_device
    # 6 images at batch 4: encoder calls on images 0-3 and 2-5
    f0, t0 = encode(state, {"images": ds.gather_images(np.arange(0, 4))})
    f1, t1 = encode(state, {"images": ds.gather_images(np.arange(2, 6))})
    feats = torch.cat([f0[:2], f1]).numpy()
    tags = torch.cat([t0[:2], t1]).numpy()
    assert feats.shape == (6, 2, 2, cfg.encoder_dim)
    np.testing.assert_array_equal(caches[False].feats.numpy(), feats)
    np.testing.assert_array_equal(caches[True].feats, feats)
    np.testing.assert_array_equal(caches[False].tags.numpy(), tags)
    idx = torch.tensor([11, 0, 5], dtype=torch.int32)
    lf, lt = caches[False].lookup(idx)
    np.testing.assert_array_equal(lf.numpy(), feats[[5, 0, 2]])
    np.testing.assert_array_equal(lt.numpy(), tags[[5, 0, 2]])
    view = caches[True].host_view(ds).gather(np.array([11, 0, 5]))
    assert "images" not in view
    np.testing.assert_array_equal(view["features"], feats[[5, 0, 2]])


def test_calibration_is_the_mean_of_the_batch_statistics(data_env):
    ds = CaptionDataset(data_env, NAME, "TRAIN")
    cfg = ModelConfig(**model_kw(30))
    tcfg = TrainConfig(**train_kw(".", calibrate_encoder_stats=2))
    state, _ = small_state(cfg)
    raw = state["encoder_stats"]
    caption._calibrate(state, cfg, tcfg, ds, CPU, lambda s: None)
    batches = loader.iterate(ds, 4, shuffle=True, seed=0, epoch=10**9,
                             drop_last=True)
    stats = []
    for batch in list(batches)[:2]:
        x = encoders.prep_images(torch.from_numpy(batch["images"]))
        stats.append(encoders.apply_encoder_caption(
            state["encoder"], raw, x, train="calibrate", enc_image_size=2,
            arch="resnet50")[1])
    got = leaves(state["encoder_stats"])
    a, b = (leaves(s) for s in stats)
    assert len(got) == len(a) == len(b) > 0
    for g, x, y in zip(got, a, b):
        assert torch.equal(g, (x * 1 + y) / 2)


@pytest.fixture(scope="module")
def jax_run(data_env, tmp_path_factory):
    """JAX's caption.main, and the init_state it starts from."""
    from indonesian_image_captioning_tpu.core.prng import root_key, stream
    from indonesian_image_captioning_tpu.train import caption as jax_caption
    from indonesian_image_captioning_tpu.train import steps as jax_steps
    wm = word_map(data_env)
    jcfg = JaxModelConfig(**model_kw(len(wm)))
    jtcfg = JaxTrainConfig(**train_kw(tmp_path_factory.mktemp("jax_ck")))
    logs = []
    _, summary = jax_caption.main(
        "attention_scn", JaxDataConfig(data_folder=data_env, data_name=NAME),
        jtcfg, model_cfg=jcfg, log=logs.append)
    init = jax_caption.init_state(
        stream(root_key(jtcfg.seed), "attention_scn_init"), jcfg,
        jax_steps.make_optimizer(jtcfg.decoder_lr, jtcfg.grad_clip))
    return summary, init, logs, jtcfg.checkpoint_dir


@pytest.mark.parametrize("variant", [
    {}, {"cache_features": True}, {"embed_grad_impl": "pallas"}])
def test_caption_main_matches_jax(data_env, jax_run, tmp_path, monkeypatch,
                                  variant):
    """The port's trainer on the CPU against JAX's, from the same weights:
    train_loss within 1e-4 relative, BLEU-4 (the gate) equal; the uncached
    (device image store), the feature-cache and the kernel-14 paths."""
    jsummary, jstate, jlogs, jdir = jax_run

    def bridged(key, cfg, optimizer, **kw):
        params = params_from_jax(jstate["params"])
        return {"params": params, "opt_state": optimizer.init(params),
                **{k: params_from_jax(jstate[k]) for k in
                   ("encoder", "encoder_stats", "tagger", "tagger_stats")}}

    monkeypatch.setattr(caption, "init_state", bridged)
    wm = word_map(data_env)
    cfg = ModelConfig(**model_kw(
        len(wm), embed_grad_impl=variant.get("embed_grad_impl", "auto")))
    tcfg = TrainConfig(**train_kw(
        tmp_path, cache_features=variant.get("cache_features", False)))
    logs = []
    _, summary = caption.main(
        "attention_scn", DataConfig(data_folder=data_env, data_name=NAME),
        tcfg, model_cfg=cfg, log=logs.append, device="cpu")
    rel = abs(summary["train_loss"] - jsummary["train_loss"]) / abs(
        jsummary["train_loss"])
    assert rel < 1e-4, (summary["train_loss"], jsummary["train_loss"])
    assert summary["best_metric"] == pytest.approx(
        jsummary["best_metric"], rel=1e-12, abs=0.0)
    assert summary["epochs_since_improvement"] == \
        jsummary["epochs_since_improvement"]
    assert (summary["start_epoch"], sorted(summary["step_losses"])) == (
        0, [0, 1])
    assert all(np.isfinite(summary["step_losses"][1]))
    name = f"checkpoint_attention_scn_{NAME}"
    assert (tmp_path / name).is_file()
    assert (tmp_path / f"BEST_{name}").exists() == os.path.exists(
        os.path.join(jdir, f"BEST_{name}"))
    store = any("device image store [TRAIN]" in line for line in logs)
    assert store != bool(variant.get("cache_features"))
    assert sum("Epoch: [" in line for line in logs) == sum(
        "Epoch: [" in line for line in jlogs)


def test_resume_restores_and_continues(data_env, tmp_path):
    """Two epochs, then resume: with epochs=2 nothing more runs and the
    Adam moments are the saved ones, bit for bit; with epochs=3 training
    starts at the third epoch."""
    wm = word_map(data_env)
    cfg = ModelConfig(**model_kw(len(wm)))
    data = DataConfig(data_folder=data_env, data_name=NAME)
    tcfg = TrainConfig(**train_kw(tmp_path, cache_features=True))
    state, _ = caption.main("attention_scn", data, tcfg, model_cfg=cfg,
                            log=lambda s: None, device="cpu")
    saved = [s["exp_avg_sq"].clone()
             for s in state["opt_state"].state.values()]
    again, summary = caption.main("attention_scn", data, tcfg, model_cfg=cfg,
                                  resume=True, log=lambda s: None,
                                  device="cpu")
    assert summary["start_epoch"] == 2 and summary["step_losses"] == {}
    assert all(torch.equal(s["exp_avg_sq"], m) for s, m in
               zip(again["opt_state"].state.values(), saved))
    logs = []
    _, summary = caption.main(
        "attention_scn", data, dataclasses.replace(tcfg, epochs=3),
        model_cfg=cfg, resume=True, log=logs.append, device="cpu")
    assert summary["start_epoch"] == 2
    assert sorted(summary["step_losses"]) == [2]
    assert "Current epoch 3\n" in logs and "Current epoch 1\n" not in logs


def parser_spec(parser):
    return sorted((a.dest, tuple(a.option_strings), a.default, a.nargs,
                   a.const, tuple(a.choices or ()))
                  for a in parser._actions if a.dest != "help")


def test_cli_parses_the_jax_flags_and_raises_on_unported_paths(data_env,
                                                               tmp_path):
    """The CLI's flags equal JAX's; a model axis (--mesh D,M with M > 1)
    raises ValueError without its process group, and on a vocabulary it
    does not divide, naming both; --fine_tune_encoder and a tagger --type
    (with --encoder_remat and --tagger_dtype) each train one tiny
    epoch."""
    assert parser_spec(cli.build_parser()) == parser_spec(
        jax_cli.build_parser())
    argv = ["-t", "attention_scn", "--epochs", "3", "-bs", "8",
            "--decoder_lr", "1e-3", "--cache_features", "--cache_dtype",
            "bfloat16", "--device_images", "off", "--head_impl", "chunked",
            "--head_tile", "512", "--decoder_dtype", "bfloat16",
            "--encoder_dtype", "float32", "--mesh_order", "colmajor",
            "--tagger_dtype", "bfloat16", "--encoder_remat", "convs",
            "--fine_tune_encoder"]
    ours = cli._override(TrainConfig(), cli.build_parser().parse_args(argv))
    theirs = jax_cli._override(JaxTrainConfig(),
                               jax_cli.build_parser().parse_args(argv))
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    spec = '{"embed_dim": 8}'
    assert cli._load_model_json(spec) == jax_cli._load_model_json(spec)
    # a model axis trains over a process group of D x M ranks, on a
    # vocabulary that M divides
    with pytest.raises(ValueError, match="vocab_size 11 is not divisible "
                       "by the model axis 2"):
        cli.main(["-t", "pure_scn", "--mesh", "2,2", "-df", data_env, "-dn",
                  NAME, "--checkpoint_dir", str(tmp_path)], device="cpu")
    wm = {"<pad>": 0, "a": 1, "<start>": 2, "b": 3}
    with pytest.raises(ValueError, match="process group has 1"):
        caption.train("pure_scn", wm, None, None,
                      TrainConfig(mesh_shape=(2, 2)), device="cpu")
    common = ["-df", data_env, "-dn", NAME, "--epochs", "1", "-bs", "4"]
    widths = json.dumps(dict(embed_dim=16, decoder_dim=16, factored_dim=12,
                             enc_image_size=2, max_caption_len=12,
                             encoder_arch="resnet50"))
    runs = {"pure_scn": ["-t", "pure_scn", "--fine_tune_encoder",
                         "--encoder_remat", "convs", "--model_json", widths],
            "tagger": ["-t", "tagger", "--tagger_dtype", "bfloat16",
                       "--encoder_remat", "--model_json",
                       '{"encoder_arch": "resnet50"}']}
    for name, extra in runs.items():
        state, summary = cli.main(common + extra + [
            "--checkpoint_dir", str(tmp_path / name)], device="cpu")
        assert np.isfinite(summary["train_loss"]), name
        assert (tmp_path / name / f"checkpoint_{name}_{NAME}").is_file()
        assert ("enc_opt_state" if name == "pure_scn" else "stats") in state
