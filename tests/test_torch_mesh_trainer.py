"""The port's data-parallel trainers, its loader's rank slices and its
mesh layouts, on the CPU.

Two gloo ranks (``tests/_torch_mesh_worker.py``, torchrun's environment)
run, in one launch:

* ``cli.train -t pure_scn --mesh 2`` for one epoch on a
  ``make_synthetic_corpus`` corpus (20 TRAIN rows at batch 8: the last
  batch leaves rank 1 only padding rows), from JAX's initial state,
  dropout 0, float32 encoders.  Its fc weights must equal JAX's
  single-device epoch within rtol 2e-4 and atol 2e-5
  (``tests/test_mesh_training.py:71``'s tolerance) and the port's one-rank
  epoch within the same; the train loss within 1e-4 relative and BLEU-4
  (the gate) equal to the one-rank run's;
* the tagger trainer at mesh (2, 1), dropout 0, its ResNet's residual
  branches damped (``tests/test_torch_tagger.py`` says why): its first
  step's loss within 1e-5 relative of the one-rank trainer's on the same
  global batch (later steps part ways as a random ResNet in train mode
  does under any change of summation order), and rank 0's checkpoint
  loading bitwise equal to both ranks' final state.

Then, in this process: ``loader.iterate``'s per-rank slices against JAX's
(``tests/test_data.py:217,248``), ``make_mesh``'s layouts against JAX's,
and the model axis raising ``NotImplementedError``.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from indonesian_image_captioning_tpu.core.config import \
    DataConfig as JaxDataConfig
from indonesian_image_captioning_tpu.core.config import \
    ModelConfig as JaxModelConfig
from indonesian_image_captioning_tpu.core.config import \
    TrainConfig as JaxTrainConfig
from indonesian_image_captioning_tpu.core.meshes import \
    make_mesh as jax_make_mesh
from indonesian_image_captioning_tpu.core.prng import root_key, stream
from indonesian_image_captioning_tpu.data import loader as jax_loader
from indonesian_image_captioning_tpu.train import caption as jax_caption
from indonesian_image_captioning_tpu.train import steps as jax_steps
from indonesian_image_captioning_tpu_torch.cli import common
from indonesian_image_captioning_tpu_torch.cli import train as cli
from indonesian_image_captioning_tpu_torch.core import meshes
from indonesian_image_captioning_tpu_torch.core.config import TrainConfig
from indonesian_image_captioning_tpu_torch.data import loader, vocab
from indonesian_image_captioning_tpu_torch.data.synthetic import \
    make_synthetic_corpus
from indonesian_image_captioning_tpu_torch.models.jax_bridge import \
    params_from_jax
from indonesian_image_captioning_tpu_torch.parallel import sharding
from indonesian_image_captioning_tpu_torch.train import caption, steps
from indonesian_image_captioning_tpu_torch.train import tagger
from test_torch_mesh import launch

torch.set_num_threads(1)
TINY = {"embed_dim": 16, "attention_dim": 16, "decoder_dim": 16,
        "factored_dim": 12, "enc_image_size": 2, "max_caption_len": 12,
        "encoder_arch": "resnet50", "dropout": 0.0}
TAGGER = {"semantic_size": 2, "encoder_arch": "resnet50", "dropout": 0.0}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_synthetic_corpus(str(tmp_path_factory.mktemp("corpus")),
                                 str(tmp_path_factory.mktemp("scn_data")),
                                 n_images=16, n_train=10, image_size=32)


def caption_argv(corpus, ckpt, mesh=None):
    argv = ["-t", "pure_scn", "-df", corpus.data_folder,
            "-dn", corpus.data_name, "--epochs", "1", "-bs", "8",
            "--encoder_dtype", "float32", "--checkpoint_dir", str(ckpt),
            "--model_json", json.dumps(TINY)]
    return argv + (["--mesh", mesh] if mesh else [])


@pytest.fixture(scope="module")
def jax_epoch(corpus, tmp_path_factory):
    """JAX's single-device pure_scn epoch and its initial state (in the
    port's layout)."""
    wm = vocab.load_json(vocab.wordmap_path(corpus.data_folder,
                                            corpus.data_name))
    jcfg = JaxModelConfig(model_type="pure_scn", vocab_size=len(wm),
                          semantic_dim=2, **TINY)
    jtcfg = JaxTrainConfig(epochs=1, batch_size=8, encoder_dtype="float32",
                           checkpoint_dir=str(tmp_path_factory.mktemp("j")))
    state, summary = jax_caption.main(
        "pure_scn", JaxDataConfig(data_folder=corpus.data_folder,
                                  data_name=corpus.data_name),
        jtcfg, model_cfg=jcfg, log=lambda s: None)
    init = jax_caption.init_state(
        stream(root_key(jtcfg.seed), "pure_scn_init"), jcfg,
        jax_steps.make_optimizer(jtcfg.decoder_lr, jtcfg.grad_clip))
    init = {k: params_from_jax(jax.device_get(init[k])) for k in
            ("params", "encoder", "encoder_stats", "tagger", "tagger_stats")}
    return (np.asarray(state["params"]["fc"]["w"]), summary["train_loss"],
            init)


@pytest.fixture(scope="module")
def ranks(corpus, jax_epoch, tmp_path_factory):
    ckpt = tmp_path_factory.mktemp("mesh_ckpt")
    tag_ckpt = tmp_path_factory.mktemp("mesh_tagger_ckpt")
    cases = [dict(case="cli_train", init=jax_epoch[2],
                  argv=caption_argv(corpus, ckpt, mesh="2")),
             dict(case="tagger_trainer", data=dataclasses.asdict(corpus),
                  tcfg=dict(epochs=1, batch_size=4, mesh_shape=(2, 1),
                            print_freq=1, checkpoint_dir=str(tag_ckpt)),
                  tagger_cfg=TAGGER, init=tagger_init())]
    out = launch(tmp_path_factory.mktemp("mesh_trainers"), {"cases": cases})
    return out, ckpt, tag_ckpt


def tagger_init():
    """A ResNet-50 tagger with every residual branch damped (bn3 scale
    x0.2): undamped, a random ResNet's train-mode forward moves by 3e-4
    under another summation order of its statistics."""
    from indonesian_image_captioning_tpu_torch.core.config import \
        TaggerConfig
    from indonesian_image_captioning_tpu_torch.models import encoders
    params, stats = encoders.init_encoder_tagger(
        torch.Generator().manual_seed(0), TaggerConfig(**TAGGER),
        arch="resnet50")
    for stage in ("layer1", "layer2", "layer3", "layer4"):
        st = params["resnet"][stage]
        for block in [st["first"], *st["rest"]]:
            block["bn3"]["scale"] = block["bn3"]["scale"] * 0.2
    return {"params": params, "stats": stats}


def bridged_init(init):
    def init_state(key, cfg, optimizer, **kw):
        params = steps.map_tree(init["params"], torch.clone)
        return {"params": params, "opt_state": optimizer.init(params),
                **{k: steps.map_tree(init[k], torch.clone) for k in
                   ("encoder", "encoder_stats", "tagger", "tagger_stats")}}
    return init_state


def test_cli_mesh_epoch_matches_jax_and_one_rank(ranks, corpus, jax_epoch,
                                                 tmp_path, monkeypatch):
    """cli.train --mesh 2: JAX's single-device epoch and the port's
    one-rank epoch, fc within rtol 2e-4 / atol 2e-5; the replicas
    bitwise equal; rank 0's checkpoint written."""
    out, ckpt, _ = ranks
    jfc, jloss, init = jax_epoch
    monkeypatch.setattr(caption, "init_state", bridged_init(init))
    state, summary = cli.main(caption_argv(corpus, tmp_path), device="cpu")
    one_fc = state["params"]["fc"]["w"].detach().numpy()
    a, b = out[0][0], out[1][0]
    assert a["params"].keys() == b["params"].keys()
    assert all(torch.equal(a["params"][k], b["params"][k])
               for k in a["params"])
    fc = a["params"]["fc/w"].numpy()
    np.testing.assert_allclose(fc, jfc, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(fc, one_fc, rtol=2e-4, atol=2e-5)
    assert a["train_loss"] == pytest.approx(jloss, rel=1e-4)
    assert a["train_loss"] == pytest.approx(summary["train_loss"], rel=1e-4)
    assert a["best_metric"] == summary["best_metric"]
    assert len(a["step_losses"][0]) == 3      # 20 rows at batch 8
    assert (ckpt / f"checkpoint_pure_scn_{corpus.data_name}").is_file()


def test_tagger_trainer_on_mesh(ranks, corpus, tmp_path, monkeypatch):
    """tagger.train at mesh (2, 1): the first step's loss is the one-rank
    trainer's on the same global batch; the replicas end bitwise equal
    and rank 0's checkpoint loads back as their state."""
    out, _, tag_ckpt = ranks
    from indonesian_image_captioning_tpu_torch.core.config import (
        DataConfig, TaggerConfig, tagger_train_config)
    init = tagger_init()
    monkeypatch.setattr(tagger, "init_state", lambda key, cfg, opt, *a, **k: {
        "params": init["params"], "stats": init["stats"],
        "opt_state": opt.init(init["params"])})
    _, summary = tagger.main(
        DataConfig(**dataclasses.asdict(corpus)),
        tagger_train_config(epochs=1, batch_size=4, print_freq=1,
                            checkpoint_dir=str(tmp_path)),
        TaggerConfig(**TAGGER), log=lambda s: None, device="cpu")
    a, b = out[0][1], out[1][1]
    assert a["step_losses"] == b["step_losses"]
    assert len(a["step_losses"][0]) == len(summary["step_losses"][0]) == 3
    assert a["step_losses"][0][0] == pytest.approx(
        summary["step_losses"][0][0], rel=1e-5)
    assert all(np.isfinite(a["step_losses"][0]))
    for key in ("params", "stats"):
        assert all(torch.equal(a[key][k], b[key][k]) for k in a[key])
    path = tag_ckpt / f"checkpoint_tagger_{corpus.data_name}"
    params, stats = common.load_tagger_state(str(path), "resnet50",
                                             device="cpu")
    from test_torch_mesh import by_path
    for got, want in ((by_path(params), a["params"]),
                      (by_path(stats), a["stats"])):
        assert got.keys() == want.keys()
        assert all(torch.equal(got[k], want[k]) for k in got)


class FakeDS:
    def __init__(self, n):
        self.n = n
        self.data = np.arange(n * 3, dtype=np.int32).reshape(n, 3)

    def __len__(self):
        return self.n

    def gather(self, idx):
        return {"images": self.data[idx],
                "caplens": np.full(len(idx), 7, np.int32)}


@pytest.mark.parametrize("count", [2, 4])
def test_iterate_rank_slices_match_jax(count):
    """Each rank's block of every global batch equals JAX's process slice,
    and the blocks put together are the one-process batch (the shuffle,
    the padding and the valid masks global)."""
    ds = FakeDS(10)             # batch 8: one full and one padded batch
    kw = dict(shuffle=True, seed=3, epoch=1, with_index=True)
    single = list(loader.iterate(ds, 8, **kw))
    per_rank = [list(loader.iterate(ds, 8, process_index=i,
                                    process_count=count, **kw))
                for i in range(count)]
    for i in range(count):
        theirs = list(jax_loader.iterate(ds, 8, process_index=i,
                                         process_count=count, **kw))
        assert len(per_rank[i]) == len(theirs) == 2
        for a, b in zip(per_rank[i], theirs):
            assert a.keys() == b.keys()
            for k in b:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for b, ref in enumerate(single):
        for key in ref:
            glued = np.concatenate([per_rank[i][b][key]
                                    for i in range(count)])
            np.testing.assert_array_equal(glued, ref[key], err_msg=key)
    with pytest.raises(ValueError, match="divisible"):
        next(loader.iterate(ds, 6, process_count=4))


@pytest.mark.parametrize("order", ["rowmajor", "colmajor"])
def test_mesh_layout_matches_jax(order):
    """Rank (d, m) of make_mesh's layout is JAX's device id at (d, m)."""
    jmesh = jax_make_mesh((4, 2), order=order)
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    np.testing.assert_array_equal(meshes._layout(4, 2, order), ids)
    with pytest.raises(ValueError, match="order"):
        meshes._layout(4, 2, "diagonal")


def test_model_axis_raises_naming_it(corpus, tmp_path):
    """--mesh D,M with M > 1, a (2, 2) TrainConfig and shard_vocab raise
    NotImplementedError naming ROADMAP.md queue 1 item 7's model axis; a
    data axis without its process group raises ValueError."""
    match = r"item 7's model axis"
    with pytest.raises(NotImplementedError, match=match):
        cli.main(caption_argv(corpus, tmp_path, mesh="2,2"), device="cpu")
    wm = {"<pad>": 0, "a": 1, "<start>": 2}
    for run in (lambda t: caption.train("pure_scn", wm, None, None, t,
                                        device="cpu"),
                lambda t: tagger.train(None, None, t, device="cpu")):
        with pytest.raises(NotImplementedError, match=match):
            run(TrainConfig(mesh_shape=(2, 2)))
        with pytest.raises(ValueError, match="process group has 1"):
            run(TrainConfig(mesh_shape=(2, 1)))
    mesh = meshes.make_mesh()
    assert (mesh.shape, mesh.size, meshes.process_data_slice(mesh)) == (
        {"data": 1, "model": 1}, 1, (0, 1))
    with pytest.raises(NotImplementedError, match=match):
        sharding.place_state(mesh, {}, shard_vocab=True)
    assert not meshes.initialize_distributed(world_size=1)
    # one rank: every leaf replicated, the state and batch as they were
    params = {"w": torch.ones(2), "b": [torch.zeros(1)]}
    opt = steps.make_optimizer(1e-3, 5.0)
    state = {"params": params, "opt_state": opt.init(params)}
    tree = sharding.state_sharding(mesh, state)
    assert tree["params"] == {"w": sharding.REPLICATED,
                              "b": [sharding.REPLICATED]}
    assert sharding.place_state(mesh, state) is state
    batch = {"caps": np.zeros((4, 3)), "n": 7}
    assert sharding.place_batch(mesh, batch)["caps"].shape == (4, 3)


def test_initialize_distributed_refuses_more_ranks_than_cards(monkeypatch):
    """On CUDA the backend is NCCL, a card for each rank of the node: more
    ranks than cards raise before any group exists, unless the caller
    names gloo (which still needs a card); another backend raises."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    kw = dict(init_method="tcp://localhost:1", world_size=2, rank=0,
              device="cuda")
    for backend in (None, "nccl"):
        with pytest.raises(RuntimeError, match="needs a card for each rank"):
            meshes.initialize_distributed(backend=backend, **kw)
    with pytest.raises(ValueError, match="'nccl' or 'gloo'"):
        meshes.initialize_distributed(backend="mpi", **kw)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            meshes.initialize_distributed(backend="gloo", **kw)
    assert not torch.distributed.is_initialized()


def test_parallel_builders_run_on_the_card_unless_asked_for_the_cpu():
    """The data-parallel step builders and the examples resolve "cuda"
    and raise without a card; they never fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    from indonesian_image_captioning_tpu_torch.core.config import \
        ModelConfig
    from indonesian_image_captioning_tpu_torch.examples import tagger_topk
    from indonesian_image_captioning_tpu_torch.parallel import train_step
    mesh = meshes.make_mesh()
    opt = steps.make_optimizer(1e-3, 5.0)
    cfg, tcfg = ModelConfig(vocab_size=30), TrainConfig()
    for build in (
            lambda: train_step.make_parallel_caption_train_step(
                cfg, tcfg, opt, mesh),
            lambda: train_step.make_parallel_caption_finetune_step(
                cfg, tcfg, opt, opt, mesh),
            lambda: train_step.make_parallel_tagger_train_step(tcfg, opt,
                                                               mesh),
            lambda: tagger_topk.main(["-i", "x.png", "-mt", "t.pt",
                                      "-tm", "tags.json"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()
