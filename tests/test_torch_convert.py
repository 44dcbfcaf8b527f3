"""The port's checkpoint converters, registry and loaders against the JAX
package, on the CPU.

Counterparts of the JAX tests of ``models/convert.py``,
``models/registry.py``, the cells' layout converters,
``models/resnet.load_torch_resnet``, ``models/torch_import.py`` and
``cli/common.py`` (``tests/test_registry_finetune.py``,
``test_scn_cell.py``, ``test_attention_lstm.py``, ``test_resnet.py``,
``test_torch_import.py``): the same seeded state_dicts go through both
packages' converters and loaders, and every leaf must be bitwise equal
after ``models/jax_bridge.py``.  Also the port's own checkpoint files,
``encoder_init`` and the ``AsyncSaver`` counterparts of
``tests/test_async_checkpoint.py``.
"""

import dataclasses
import sys
import types
import weakref

import jax
import numpy as np
import pytest
import torch

from indonesian_image_captioning_tpu.cli import common as jax_common
from indonesian_image_captioning_tpu.core.config import \
    ModelConfig as JaxModelConfig
from indonesian_image_captioning_tpu.core.prng import root_key as jax_root_key
from indonesian_image_captioning_tpu.models import convert as jax_convert
from indonesian_image_captioning_tpu.models import decoders as jax_decoders
from indonesian_image_captioning_tpu.models import lstm_cell as jax_lstm
from indonesian_image_captioning_tpu.models import registry as jax_registry
from indonesian_image_captioning_tpu.models import resnet as jax_resnet
from indonesian_image_captioning_tpu.models import scn_cell as jax_scn
from indonesian_image_captioning_tpu.train import caption as jax_caption
from indonesian_image_captioning_tpu.train import steps as jax_steps
from indonesian_image_captioning_tpu_torch.cli import common
from indonesian_image_captioning_tpu_torch.cli import train as cli_train
from indonesian_image_captioning_tpu_torch.core import checkpoint as ckpt
from indonesian_image_captioning_tpu_torch.core.config import (ModelConfig,
                                                               TaggerConfig)
from indonesian_image_captioning_tpu_torch.models import (convert, decoders,
                                                          encoders,
                                                          lstm_cell,
                                                          registry, resnet,
                                                          scn_cell,
                                                          torch_import)
from indonesian_image_captioning_tpu_torch.models.jax_bridge import \
    params_from_jax
from indonesian_image_captioning_tpu_torch.train import caption, steps

torch.set_num_threads(1)
CPU = torch.device("cpu")
DIMS = dict(embed_dim=16, attention_dim=12, decoder_dim=16, factored_dim=8,
            semantic_dim=6)
FAKE_MOD = "fake_reference_models_for_port"


def items(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from items(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from items(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def assert_bitwise(ours, theirs_port_layout):
    """Two port-layout trees: the same paths, dtypes, shapes and bits."""
    a, b = dict(items(ours)), dict(items(theirs_port_layout))
    assert a.keys() == b.keys()
    for k in a:
        assert torch.is_tensor(a[k]), k
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def assert_jax_equal(ours, jax_tree):
    """A port tree bitwise a JAX tree carried across by the bridge."""
    assert_bitwise(ours, params_from_jax(jax_tree))


def assert_sd_equal(ours, theirs):
    """A port state_dict (tensors) bitwise a JAX one (arrays)."""
    assert ours.keys() == theirs.keys()
    for k in ours:
        a, b = ours[k].numpy(), np.asarray(theirs[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def seeded_like(sd, seed):
    """A reference-layout state_dict of sd's keys and shapes, its values
    drawn from a seeded numpy generator (float32)."""
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=np.shape(v)).astype(np.float32)
            for k, v in sd.items()}


# ---- registry and decoder converters ----

def test_registry_sets():
    assert registry.scn_based_model == jax_registry.scn_based_model == {
        "pure_scn", "attention_scn"}
    assert registry.att_based_model == jax_registry.att_based_model == {
        "pure_attention", "attention_scn"}
    assert decoders.ATT_BASED_MODELS == jax_decoders.ATT_BASED_MODELS
    with pytest.raises(ValueError):
        registry.make_config("bogus", 10)
    for mt in decoders.MODEL_TYPES:
        assert dataclasses.asdict(registry.make_config(mt, 40, **DIMS)) == \
            dataclasses.asdict(jax_registry.make_config(mt, 40, **DIMS))


@pytest.mark.parametrize("model_type", decoders.MODEL_TYPES)
def test_decoder_torch_roundtrip(model_type):
    """A seeded reference-layout decoder state_dict: the port's
    decoder_from_torch (and load_decoder) equal JAX's bitwise, and
    decoder_to_torch gives back JAX's state_dict bitwise."""
    jcfg = JaxModelConfig(model_type=model_type, vocab_size=40, **DIMS)
    cfg = ModelConfig(model_type=model_type, vocab_size=40, **DIMS)
    shape_sd = jax_convert.decoder_to_torch(
        jax_decoders.init_decoder(jax.random.key(0), jcfg), jcfg)
    sd = seeded_like(shape_sd, 1)
    jax_params = jax_convert.decoder_from_torch(sd, jcfg)
    ours = convert.decoder_from_torch(
        {k: torch.from_numpy(v) for k, v in sd.items()}, cfg)
    assert_jax_equal(ours, jax_params)
    assert_jax_equal(convert.decoder_from_torch(sd, cfg), jax_params)
    back = convert.decoder_to_torch(ours, cfg)
    assert_sd_equal(back, jax_convert.decoder_to_torch(jax_params, jcfg))
    assert_sd_equal(back, sd)
    loaded, cfg2 = registry.load_decoder(model_type, sd, vocab_size=40,
                                         device="cpu", **DIMS)
    assert cfg2 == cfg
    assert_jax_equal(loaded, jax_params)
    # a fresh draw has JAX's tree and shapes (other values: other PRNGs)
    fresh, _ = registry.load_decoder(model_type, None, vocab_size=40,
                                     device="cpu", **DIMS)
    want = params_from_jax(jax_decoders.init_decoder(jax.random.key(0),
                                                     jcfg))
    assert {k: v.shape for k, v in items(fresh)} == \
        {k: v.shape for k, v in items(want)}


def test_torch_layout_roundtrip(rng):
    """The SCN cell's reference layout (In 8, hidden 12, semantic 6,
    factor 10) -> the gate layout -> back, bitwise, and equal to JAX's."""
    H, F, S, In = 12, 10, 6, 8
    tw = {"weight_ia": (In, 4 * F), "weight_ib": (S, 4 * F),
          "weight_ic": (H, 4 * F), "weight_ha": (H, 4 * F),
          "weight_hb": (S, 4 * F), "weight_hc": (H, 4 * F),
          "bias_ih": (4 * H,), "bias_hh": (4 * H,)}
    tw = {k: rng.normal(size=s).astype(np.float32) for k, s in tw.items()}
    params = scn_cell.from_torch_layout(**{k: torch.from_numpy(v)
                                           for k, v in tw.items()})
    assert_jax_equal(params, jax_scn.from_torch_layout(**tw))
    assert all(v.is_contiguous() for v in params.values())
    back = scn_cell.to_torch_layout(params)
    for k in tw:
        np.testing.assert_array_equal(back[k].numpy(), tw[k])
        np.testing.assert_array_equal(
            back[k].numpy(),
            np.asarray(jax_scn.to_torch_layout(
                jax_scn.from_torch_layout(**tw))[k]))


def test_lstm_roundtrip():
    jp = jax_lstm.init_lstm_cell(jax.random.key(3), 6, 5)
    tw = {k: np.asarray(v) for k, v in jax_lstm.to_torch_layout(jp).items()}
    params = lstm_cell.from_torch_layout(**{k: torch.from_numpy(v)
                                            for k, v in tw.items()})
    assert_jax_equal(params, jax_lstm.from_torch_layout(**tw))
    assert_jax_equal(params, jp)
    back = lstm_cell.to_torch_layout(params)
    for k in tw:
        np.testing.assert_array_equal(back[k].numpy(), tw[k])


# ---- ResNet and encoder converters ----

def torchvision_sd(rng, arch="resnet50", semantic=None):
    """A synthetic torchvision-format resnet state_dict (seeded)."""
    sd = {}

    def add_conv(name, cout, cin, k):
        sd[name + ".weight"] = (rng.normal(size=(cout, cin, k, k))
                                * 0.05).astype(np.float32)

    def add_bn(name, c):
        sd[name + ".weight"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        sd[name + ".bias"] = rng.normal(size=c).astype(np.float32) * 0.1
        sd[name + ".running_mean"] = rng.normal(size=c).astype(
            np.float32) * 0.1
        sd[name + ".running_var"] = rng.uniform(0.5, 2.0, c).astype(
            np.float32)

    add_conv("conv1", 64, 3, 7)
    add_bn("bn1", 64)
    cin = 64
    for stage, (n, width) in enumerate(zip(resnet.BLOCKS[arch],
                                           resnet.WIDTHS), start=1):
        cout = width * 4
        for b in range(n):
            pre = f"layer{stage}.{b}"
            add_conv(pre + ".conv1", width, cin, 1)
            add_bn(pre + ".bn1", width)
            add_conv(pre + ".conv2", width, width, 3)
            add_bn(pre + ".bn2", width)
            add_conv(pre + ".conv3", cout, width, 1)
            add_bn(pre + ".bn3", cout)
            if b == 0:
                add_conv(pre + ".downsample.0", cout, cin, 1)
                add_bn(pre + ".downsample.1", cout)
            cin = cout
    return sd


def as_sequential(sd, semantic=None, rng=None):
    """The reference encoders' layout: resnet.<Sequential index>...,
    and a tagger's linear.*."""
    out = convert._sequential_sd(sd)
    if semantic:
        out["linear.weight"] = rng.normal(size=(semantic, 2048)).astype(
            np.float32) * 0.01
        out["linear.bias"] = rng.normal(size=semantic).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def resnet_sds():
    rng = np.random.default_rng(5)
    sd = torchvision_sd(rng)
    return sd, as_sequential(sd), as_sequential(sd, 7, rng)


def test_torch_state_dict_converter_shapes(resnet_sds):
    """load_torch_resnet on a torchvision-format resnet50 state_dict equals
    JAX's bitwise (a renaming: the port keeps OIHW), runs, and the
    encoders' converters and their inverses equal JAX's."""
    sd, cap_sd, tag_sd = resnet_sds
    params, stats = resnet.load_torch_resnet(sd, arch="resnet50")
    jp, js = jax_resnet.load_torch_resnet(sd, arch="resnet50")
    assert_jax_equal(params, jp)
    assert_jax_equal(stats, js)
    assert torch.equal(params["layer2"]["rest"][1]["conv2"],
                       torch.from_numpy(sd["layer2.2.conv2.weight"]))
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(1, 64, 64, 3)).astype(np.float32))
    feat, _ = resnet.apply_resnet(params, stats, x, arch="resnet50")
    assert feat.shape == (1, 2, 2, 2048)

    ep, es = convert.encoder_caption_from_torch(cap_sd, arch="resnet50")
    jep, jes = jax_convert.encoder_caption_from_torch(cap_sd,
                                                      arch="resnet50")
    assert_jax_equal(ep, jep)
    assert_jax_equal(es, jes)
    assert_sd_equal(convert.encoder_caption_to_torch(ep, es),
                    jax_convert.encoder_caption_to_torch(jep, jes,
                                                         arch="resnet50"))
    assert_sd_equal(convert.encoder_caption_to_torch(ep, es), cap_sd)

    tp, ts = convert.encoder_tagger_from_torch(
        {k: torch.from_numpy(v) for k, v in tag_sd.items()}, arch="resnet50")
    jtp, jts = jax_convert.encoder_tagger_from_torch(tag_sd, arch="resnet50")
    assert_jax_equal(tp, jtp)
    assert_jax_equal(ts, jts)
    assert_sd_equal(convert.encoder_tagger_to_torch(tp, ts),
                    jax_convert.encoder_tagger_to_torch(jtp, jts,
                                                        arch="resnet50"))
    assert_sd_equal(convert.encoder_tagger_to_torch(tp, ts), tag_sd)


# ---- the training format (stubbed classes) ----

def transient_module(sd, class_name):
    """A module tree holding sd, its root of a class that unpickling in
    this process cannot resolve (its module is gone at load time)."""
    mod = sys.modules.get(FAKE_MOD) or types.ModuleType(FAKE_MOD)
    cls = type(class_name, (torch.nn.Module,), {"__module__": FAKE_MOD})
    setattr(mod, class_name, cls)
    sys.modules[FAKE_MOD] = mod
    root = cls()
    for key, v in sd.items():
        *path, leaf = key.split(".")
        m = root
        for name in path:
            if name not in m._modules:
                m.add_module(name, torch.nn.Module())
            m = m._modules[name]
        t = torch.as_tensor(np.asarray(v))
        if leaf.startswith("running_"):
            m.register_buffer(leaf, t)
        else:
            m.register_parameter(leaf, torch.nn.Parameter(t))
    return root


def test_stubbed_unpickle_and_extraction(tmp_path):
    enc = transient_module({"linear.weight": np.ones((3, 4), np.float32),
                            "linear.bias": np.arange(3.0, dtype=np.float32),
                            "running": np.arange(3.0, dtype=np.float32),
                            "sub.0.weight": np.eye(2, 3, dtype=np.float32)},
                           "FakeEncoder")
    snapshot = {k: v.clone() for k, v in enc.state_dict().items()}
    path = tmp_path / "checkpoint_tagger_foo.pth.tar"
    torch.save({"epoch": 3, "epochs_since_improvement": 1,
                "accuracy": 87.5, "encoder": enc,
                "encoder_optimizer": torch.optim.Adam(enc.parameters())},
               path)
    sys.modules.pop(FAKE_MOD, None)
    got = torch_import.load_training_checkpoint(str(path))
    assert got["epoch"] == 3 and got["accuracy"] == 87.5
    assert "encoder_optimizer" not in got
    assert set(got["encoder"]) == set(snapshot)
    for k in snapshot:
        assert torch.equal(got["encoder"][k], snapshot[k])
    raw = torch.load(path, map_location="cpu", weights_only=False,
                     pickle_module=torch_import._PickleShim)
    assert torch_import.is_training_format(raw)


def test_is_training_format():
    assert torch_import.is_training_format({"encoder": object(),
                                            "decoder": object()})
    assert not torch_import.is_training_format(
        {"encoder_model_state_dict": {}, "decoder_model_state_dict": {}})


# ---- the loaders on the three families ----

CAP_CFG = dict(model_type="attention_scn", vocab_size=30,
               encoder_arch="resnet50", semantic_dim=7, **{
                   k: v for k, v in DIMS.items() if k != "semantic_dim"})


@pytest.fixture(scope="module")
def families(tmp_path_factory, resnet_sds):
    """One caption model and tagger written as the reference's serve and
    training formats; the files' paths and the state_dicts."""
    _, cap_sd, tag_sd = resnet_sds
    d = tmp_path_factory.mktemp("families")
    jcfg = JaxModelConfig(**CAP_CFG)
    dec_sd = seeded_like(jax_convert.decoder_to_torch(
        jax_decoders.init_decoder(jax.random.key(0), jcfg), jcfg), 2)
    t = {k: torch.from_numpy(v) for k, v in cap_sd.items()}
    files = {"serve": (d / "caption.pth.tar", d / "tagger.pth.tar"),
             "training": (d / "BEST_caption.pth.tar",
                          d / "BEST_tagger.pth.tar")}
    torch.save({"encoder_model_state_dict": t,
                "decoder_model_state_dict": {
                    k: torch.from_numpy(v) for k, v in dec_sd.items()}},
               files["serve"][0])
    torch.save({"model_state_dict": {k: torch.from_numpy(v)
                                     for k, v in tag_sd.items()}},
               files["serve"][1])
    try:
        torch.save({"epoch": 4, "bleu-4": 0.2,
                    "encoder": transient_module(cap_sd, "EncoderCaption"),
                    "decoder": transient_module(dec_sd, "AttentionSCN"),
                    "encoder_optimizer": None, "decoder_optimizer": None},
                   files["training"][0])
        torch.save({"epoch": 4, "accuracy": 90.0,
                    "encoder": transient_module(tag_sd, "EncoderTagger"),
                    "encoder_optimizer": None}, files["training"][1])
    finally:
        sys.modules.pop(FAKE_MOD, None)
    return files, dec_sd


@pytest.mark.parametrize("family", ["serve", "training"])
def test_loaders_match_jax_on_reference_families(families, family):
    files, _ = families
    cap, tag = (str(p) for p in files[family])
    cfg, jcfg = ModelConfig(**CAP_CFG), JaxModelConfig(**CAP_CFG)
    state = common.load_caption_state(cap, cfg, tag, device="cpu")
    jstate = jax_common.load_caption_state(cap, jcfg, tag)
    assert state.keys() == {"params", "encoder", "encoder_stats", "tagger",
                            "tagger_stats"}
    for k in state:
        assert_jax_equal(state[k], jstate[k])
    params, stats = common.load_tagger_state(tag, "resnet50", device="cpu")
    jp, js = jax_common.load_tagger_state(tag, "resnet50")
    assert_jax_equal(params, jp)
    assert_jax_equal(stats, js)
    # and the tagger evaluates
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 64, 64, 3)).astype(np.float32))
    probs, _ = encoders.apply_encoder_tagger(params, stats, x,
                                             arch="resnet50")
    assert probs.shape == (2, 7) and bool(((probs >= 0) & (probs <= 1))
                                          .all())


def test_loaders_default_to_the_card(families):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    files, _ = families
    cap, tag = (str(p) for p in files["serve"])
    with pytest.raises(RuntimeError, match="CUDA"):
        common.load_tagger_state(tag, "resnet50")
    with pytest.raises(RuntimeError, match="CUDA"):
        common.load_caption_state(cap, ModelConfig(**CAP_CFG), tag)
    with pytest.raises(RuntimeError, match="CUDA"):
        registry.load_decoder("pure_scn", None, vocab_size=10, **DIMS)


def test_own_checkpoint_files_roundtrip(families, tmp_path):
    """The port's own files (save_checkpoint's caption state with Adam,
    the tagger trainer's {"state": {"params", "stats"}}) load bitwise."""
    files, _ = families
    cfg = ModelConfig(**CAP_CFG)
    state = common.load_caption_state(str(files["serve"][0]), cfg,
                                      str(files["serve"][1]), device="cpu")
    opt = steps.make_optimizer(4e-4, 5.0)
    payload = {"state": {**state, "opt_state": opt.init(
        state["params"]).state_dict()}, "epoch": 1,
        "epochs_since_improvement": 0, "metric": 0.5}
    path = ckpt.save_checkpoint(str(tmp_path), "attention_scn", "d",
                                payload, is_best=False)
    tag_path = str(tmp_path / "checkpoint_tagger_d")
    ckpt.save_pytree(tag_path, {"state": {"params": state["tagger"],
                                          "stats": state["tagger_stats"]}})
    for tagger in (None, tag_path, path):
        got = common.load_caption_state(path, cfg, tagger, device="cpu")
        assert_bitwise(got, state)
    for f in (tag_path, path):
        p, s = common.load_tagger_state(f, "resnet50", device="cpu")
        assert_bitwise({"p": p, "s": s}, {"p": state["tagger"],
                                          "s": state["tagger_stats"]})
    with pytest.raises(ValueError, match="not a caption checkpoint"):
        common.load_caption_state(str(files["serve"][1]), cfg,
                                  device="cpu")


def test_fresh_tagger_when_none_is_given(families):
    files, _ = families
    cfg = ModelConfig(**CAP_CFG)
    state = common.load_caption_state(str(files["serve"][0]), cfg,
                                      device="cpu")
    want, want_s = encoders.init_encoder_tagger(
        torch.Generator().manual_seed(0),
        TaggerConfig(semantic_size=7, encoder_arch="resnet50"),
        arch="resnet50")
    assert_bitwise({"p": state["tagger"], "s": state["tagger_stats"]},
                   {"p": want, "s": want_s})


# ---- encoder_init ----

def test_encoder_init_matches_jax(tmp_path, resnet_sds):
    """init_state(encoder_init=) loads the caption encoder as JAX's does,
    bare or under encoder_model_state_dict."""
    _, cap_sd, _ = resnet_sds
    cfg, jcfg = ModelConfig(**CAP_CFG), JaxModelConfig(**CAP_CFG)
    t = {k: torch.from_numpy(v) for k, v in cap_sd.items()}
    paths = [str(tmp_path / "wrapped.pth"), str(tmp_path / "bare.pth")]
    torch.save({"encoder_model_state_dict": t}, paths[0])
    torch.save(t, paths[1])
    jst = jax_caption.init_state(jax_root_key(0), jcfg,
                                 jax_steps.make_optimizer(4e-4, 5.0),
                                 encoder_init=paths[0])
    for path in paths:
        st = caption.init_state(torch.Generator().manual_seed(0), cfg,
                                steps.make_optimizer(4e-4, 5.0),
                                encoder_init=path, device=CPU)
        assert_jax_equal(st["encoder"], jst["encoder"])
        assert_jax_equal(st["encoder_stats"], jst["encoder_stats"])


def test_cli_encoder_init_reaches_the_trainer(monkeypatch, tmp_path):
    seen = {}
    monkeypatch.setattr(caption, "main",
                        lambda *a, **kw: seen.update(kw) or "ran")
    assert cli_train.main(["-t", "pure_scn", "--encoder_init", "enc.pth",
                           "--checkpoint_dir", str(tmp_path)]) == "ran"
    assert seen["encoder_init"] == "enc.pth"


# ---- AsyncSaver (tests/test_async_checkpoint.py:65, :78) ----

def _payload(seed):
    return {"state": {"params": {"w": torch.full((3,), float(seed))}},
            "epoch": seed, "epochs_since_improvement": 0, "metric": 0.0}


def test_async_saver_last_submit_wins(tmp_path):
    saver = ckpt.AsyncSaver()
    try:
        for seed in range(3):
            saver.submit(str(tmp_path), "m", "d", _payload(seed), False)
        saver.wait()
    finally:
        saver.close()
    got = ckpt.load_checkpoint(str(tmp_path), "m", "d")
    assert int(got["epoch"]) == 2
    assert torch.equal(got["state"]["params"]["w"], torch.full((3,), 2.0))


def test_async_saver_worker_error_raises_on_wait(tmp_path):
    bad = tmp_path / "file_not_dir"
    bad.write_text("x")
    saver = ckpt.AsyncSaver()
    try:
        saver.submit(str(bad / "sub"), "m", "d", _payload(0), False)
        with pytest.raises(OSError):
            saver.wait()
        # the saver is usable again once the error has surfaced
        saver.submit(str(tmp_path), "m", "d", _payload(5), False)
        saver.wait()
    finally:
        saver.close()
    assert int(ckpt.load_checkpoint(str(tmp_path), "m", "d")["epoch"]) == 5


def test_async_saver_frees_each_snapshot_after_its_write(tmp_path,
                                                         monkeypatch):
    """The worker keeps no reference to a written checkpoint's snapshot
    (on the card, its device clones and their pinned host copy) while it
    waits for the next submit."""
    refs = []
    snapshot = ckpt._snapshot

    def spy(tree):
        snap = snapshot(tree)
        refs.append(weakref.ref(snap["state"]["params"]["w"]))
        return snap

    monkeypatch.setattr(ckpt, "_snapshot", spy)
    saver = ckpt.AsyncSaver()
    try:
        saver.submit(str(tmp_path), "m", "d", _payload(1), False)
        saver.wait()
        assert refs[0]() is None
    finally:
        saver.close()
    assert [sorted(t) for t in saver.timings] == [
        ["bytes", "copy", "wait", "write"]]
    assert saver.timings[0]["bytes"] == 0       # nothing on a card
