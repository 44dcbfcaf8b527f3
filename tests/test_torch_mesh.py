"""The port's data-parallel steps on two gloo ranks against the JAX package,
on the CPU.

Two processes (``tests/_torch_mesh_worker.py``, started with torchrun's
environment on a free port) form a (2, 1) mesh and each runs a step of
``parallel/train_step.py`` on its half of a global batch, from weights
bridged from JAX (``models/jax_bridge.py``), dropout 0.  Every case runs
in one launch of the two ranks; the tests compare what they wrote with
JAX's single-device step on the whole batch:

* the frozen-encoder caption step (``attention_scn``), the ranks' token
  counts 12 and 14: ``tests/test_torch_train_step.py``'s tolerances (the
  loss 1e-5 relative, gradients 1e-4 of their scale, at least 1);
* the same with the ranks' token counts 21 and 4, also against the mean
  of the two halves' own losses (what averaging each rank's mean, DDP's
  default, would give), which it must not be;
* the fine-tune step (one image a rank: the train-mode BatchNorm's
  statistics span both ranks) and the tagger step (two images a rank;
  again under encoder_remat="blocks", which recomputes each block's
  synchronised BatchNorm in the backward):
  ``tests/test_torch_finetune.py``'s and ``tests/test_torch_tagger.py``'s
  tolerances (the loss 1e-4 relative, gradients 2e-3 of each leaf's
  largest, weights within 2 lr, statistics 1e-4 relative); the one-rank
  step on rank 0's half alone misses JAX's statistics, the control that
  shows the synchronisation at work.

Both ranks must end with bitwise-equal parameters.
"""

import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from indonesian_image_captioning_tpu.core.config import \
    ModelConfig as JaxModelConfig
from indonesian_image_captioning_tpu.core.config import \
    TrainConfig as JaxTrainConfig
from indonesian_image_captioning_tpu.models import decoders as jax_decoders
from indonesian_image_captioning_tpu.ops import losses as jax_losses
from indonesian_image_captioning_tpu.train import steps as jax_steps
from indonesian_image_captioning_tpu_torch.core.config import (ModelConfig,
                                                               TrainConfig)
from indonesian_image_captioning_tpu_torch.models.jax_bridge import \
    params_from_jax
from indonesian_image_captioning_tpu_torch.train import steps
from test_torch_finetune import CFG as FT_CFG
from test_torch_finetune import B as FT_B
from test_torch_finetune import jax_finetune_case  # noqa: F401 (fixture)
from test_torch_finetune import port_finetune_state
from test_torch_tagger import ARCH, LR, by_path, jax_tree, rel_err
from test_torch_tagger import data_env  # noqa: F401 (fixture)
from test_torch_tagger import jax_step_case  # noqa: F401 (fixture)
from test_torch_tagger import port_state
from _torch_tmp import tmp_path, tmp_path_factory  # noqa: F401 (fixtures)

torch.set_num_threads(1)
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "_torch_mesh_worker.py")
T = 8
CAP_KW = dict(model_type="attention_scn", vocab_size=41, embed_dim=16,
              attention_dim=12, decoder_dim=16, factored_dim=8,
              semantic_dim=10, encoder_dim=24, enc_image_size=2,
              max_caption_len=T + 1, dropout=0.0)
CAPLENS = {"even": [2, 8, 5, 3, 8, 6],      # tokens 12 and 14 a rank
           "uneven": [8, 8, 8, 2, 2, 3]}    # tokens 21 and 4


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(tmp_path, inputs, n=2, timeout=600):
    """Run the worker on n ranks; -> each rank's list of case results."""
    path = tmp_path / "inputs.pt"
    torch.save(inputs, path)
    prefix = str(tmp_path / "rank")
    port = free_port()
    procs = []
    for r in range(n):
        env = {**os.environ, "WORLD_SIZE": str(n), "RANK": str(r),
               "LOCAL_RANK": str(r), "LOCAL_WORLD_SIZE": str(n),
               "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
               "OMP_NUM_THREADS": "1"}
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, str(path), prefix], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-6000:]}"
    out = [torch.load(f"{prefix}{r}.pt", weights_only=False)
           for r in range(n)]
    # the states are hundreds of MB: keep the suite's temporary disk small
    for f in [path] + [f"{prefix}{r}.pt" for r in range(n)]:
        os.remove(f)
    return out


def caption_batch(caplens):
    rng = np.random.default_rng(6)
    B = len(caplens)
    return dict(enc=(rng.normal(size=(B, 2, 2, 24)) * 0.5).astype(np.float32),
                tags=rng.uniform(size=(B, 10)).astype(np.float32),
                caps=rng.integers(1, 41, size=(B, T + 1)).astype(np.int32),
                caplens=np.asarray(caplens, np.int32))


def torch_batch(b):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in b.items()}


@pytest.fixture(scope="module")
def jparams():
    return jax_decoders.init_decoder(jax.random.key(3),
                                     JaxModelConfig(**CAP_KW))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jparams, jax_finetune_case,  # noqa: F811
          jax_step_case):  # noqa: F811
    """Every case on two ranks, in one launch."""
    tcfg = dict(batch_size=6)
    cases = [dict(case="caption_step", cfg=CAP_KW, tcfg=tcfg,
                  params=params_from_jax(jparams),
                  batch=torch_batch(caption_batch(CAPLENS[k])))
             for k in ("even", "uneven")]
    c = jax_finetune_case
    state = port_finetune_state(c["state"], steps.make_optimizer(1e-3, 5.0),
                                steps.make_optimizer(1e-3, 5.0))
    cases.append(dict(
        case="finetune_step", cfg=FT_CFG,
        tcfg=dict(batch_size=FT_B, fine_tune_encoder=True),
        state={k: v for k, v in state.items()
               if k not in ("opt_state", "enc_opt_state")},
        batch=dict(images=torch.tensor(c["images"]),
                   tags=torch.tensor(c["tags"]),
                   caps=torch.tensor(c["caps"]).long(),
                   caplens=torch.tensor(c["caplens"]).long())))
    t = jax_step_case
    for remat in (False, "blocks"):
        cases.append(dict(
            case="tagger_step",
            tcfg=dict(batch_size=4, decoder_lr=LR, encoder_remat=remat),
            arch=ARCH, params=params_from_jax(t["state"]["params"]),
            stats=params_from_jax(t["state"]["stats"]),
            batch={k: torch.tensor(np.asarray(v))
                   for k, v in t["batch"].items()}))
    return launch(tmp_path_factory.mktemp("mesh_steps"), {"cases": cases})


def assert_replicas_equal(ranks, i, keys=("params",)):
    for key in keys:
        a, b = ranks[0][i][key], ranks[1][i][key]
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), (key, k)


def jax_caption_reference(jparams, batch):
    """JAX's step metrics on the whole batch and its clamped gradients."""
    jcfg = JaxModelConfig(**CAP_KW)
    jt = JaxTrainConfig(batch_size=6)
    jopt = jax_steps.make_optimizer(jt.decoder_lr, jt.grad_clip)
    _, jstep = jax_steps.make_caption_train_step(jcfg, jt, jopt,
                                                 donate=False)
    _, jm = jstep({"params": jparams, "opt_state": jopt.init(jparams)},
                  batch["enc"], batch["tags"], batch["caps"],
                  batch["caplens"], jax.random.key(0))

    def jloss(p):
        out = jax_decoders.teacher_forcing(
            p, jcfg, batch["enc"], batch["tags"], batch["caps"],
            batch["caplens"], train=True)
        return jax_losses.caption_loss(out, batch["caps"], jt.alpha_c)[0]

    grads = jax.tree.map(lambda g: np.clip(g, -5, 5),
                         jax.grad(jloss)(jparams))
    return jax.device_get(jm), by_path(params_from_jax(grads))


@pytest.mark.parametrize("which", ["even", "uneven"])
def test_caption_step_matches_jax(ranks, jparams, which):
    """Kernels 8/9's plain versions on each rank's rows, the loss over the
    global token count, the gradients summed: JAX's single-device step on
    the whole batch."""
    i = ("even", "uneven").index(which)
    batch = caption_batch(CAPLENS[which])
    jm, jgrads = jax_caption_reference(jparams, batch)
    assert_replicas_equal(ranks, i)
    for r in range(2):
        m = ranks[r][i]["metrics"][0]
        for k in ("loss", "ce", "alpha_penalty"):
            assert m[k] == pytest.approx(float(jm[k]), rel=1e-5), (r, k)
        assert m["top5"] == pytest.approx(float(jm["top5"]), abs=1e-4)
        assert m["n_tokens"] == float(jm["n_tokens"])
    grads = ranks[0][i]["grads"]
    assert grads.keys() == jgrads.keys()
    for k, g in grads.items():
        ref = jgrads[k].numpy()
        scale = max(float(np.abs(ref).max()), 1.0)
        assert float(np.abs(g.numpy() - ref).max()) <= 1e-4 * scale, k


def test_unequal_token_counts_take_the_global_mean(ranks, jparams):
    """Rank 0 holds 21 tokens, rank 1 four: the step's loss is the global
    token mean (JAX's), not the mean of the two ranks' own means."""
    batch = caption_batch(CAPLENS["uneven"])
    half = [{k: v[s] for k, v in batch.items()}
            for s in (slice(0, 3), slice(3, 6))]
    tokens = [int((h["caplens"] - 1).sum()) for h in half]
    assert tokens[0] >= 2 * tokens[1], tokens
    cfg = ModelConfig(**CAP_KW)
    own = []
    for h in half:
        params = params_from_jax(jparams)
        opt = steps.make_optimizer(4e-4, 5.0)
        _, step = steps.make_caption_train_step(cfg, TrainConfig(), opt,
                                                device="cpu")
        b = torch_batch(h)
        _, m = step({"params": params, "opt_state": opt.init(params)},
                    b["enc"], b["tags"], b["caps"], b["caplens"])
        own.append(float(m["loss"]))
    jm, _ = jax_caption_reference(jparams, batch)
    got = ranks[0][1]["metrics"][0]["loss"]
    assert got == pytest.approx(float(jm["loss"]), rel=1e-5)
    ddp = sum(own) / 2
    assert abs(ddp - float(jm["loss"])) > 100 * 1e-5 * float(jm["loss"]), (
        ddp, float(jm["loss"]))


def test_finetune_step_synced_batchnorm_matches_jax(ranks,
                                                    jax_finetune_case):  # noqa: F811
    """One image a rank: the parallel fine-tune step equals JAX's step on
    both images (tests/test_mesh_training.py's synchronised BatchNorm),
    and the one-rank step on rank 0's image alone does not."""
    c = jax_finetune_case
    out = ranks[0][2]
    assert_replicas_equal(ranks, 2, ("params", "encoder", "stats"))
    for k in ("loss", "ce", "alpha_penalty"):
        assert out["metrics"][k] == pytest.approx(float(c["metrics"][k]),
                                                  rel=1e-4), k
    assert out["metrics"]["n_tokens"] == float(c["metrics"]["n_tokens"])
    lrs = {"params": 4e-4, "encoder": 1e-4}
    for tree, opt_key in (("params", "opt_state"),
                          ("encoder", "enc_opt_state")):
        grads = by_path(params_from_jax(c["new"][opt_key][1]))
        new_ref = by_path(params_from_jax(c["new"][tree]))
        ours = out[tree]
        assert ours.keys() == new_ref.keys()
        for k, p in ours.items():
            if k in out[tree + "_grads"]:
                g, ref = out[tree + "_grads"][k].numpy(), grads[k].numpy()
                assert float(np.abs(g - ref).max()) <= max(
                    2e-3 * float(np.abs(ref).max()), 1e-6), (tree, k)
            np.testing.assert_allclose(p.numpy(), new_ref[k].numpy(),
                                       atol=2 * lrs[tree], rtol=0,
                                       err_msg=f"{tree}/{k}")
    ref = by_path(params_from_jax(c["new"]["encoder_stats"]))
    for k, v in out["stats"].items():
        assert rel_err(v.numpy(), ref[k].numpy()) < 1e-4, k

    # the control: rank 0's image alone gives other statistics
    cfg = ModelConfig(**FT_CFG)
    tcfg = TrainConfig(batch_size=1, fine_tune_encoder=True)
    dec_opt = steps.make_optimizer(tcfg.decoder_lr, 5.0)
    enc_opt = steps.make_optimizer(tcfg.encoder_lr, 5.0)
    state = port_finetune_state(c["state"], dec_opt, enc_opt)
    _, step = steps.make_caption_finetune_train_step(cfg, tcfg, dec_opt,
                                                     enc_opt, device="cpu")
    step(state, c["images"][:1], torch.tensor(c["tags"][:1]),
         torch.tensor(c["caps"][:1]).long(),
         torch.tensor(c["caplens"][:1]).long())
    alone = by_path(state["encoder_stats"])
    assert max(rel_err(alone[k].numpy(), ref[k].numpy()) for k in ref) > \
        1e-2


def test_tagger_step_synced_batchnorm_matches_jax(ranks,
                                                  jax_step_case):  # noqa: F811
    """Two images a rank: the parallel tagger step equals JAX's on four
    (tests/test_torch_tagger.py's tolerances); the one-rank step on rank
    0's two images misses JAX's statistics."""
    c = jax_step_case
    out = ranks[0][3]
    assert_replicas_equal(ranks, 3, ("params", "stats"))
    assert out["metrics"]["loss"] == pytest.approx(
        float(c["metrics"]["loss"]), rel=1e-4)
    assert out["metrics"]["acc"] == float(c["metrics"]["acc"])
    grads = jax_tree(jax.tree.map(lambda g: np.clip(g, -5, 5), c["grads"]))
    new_ref = jax_tree(c["new_state"]["params"])
    assert out["params"].keys() == new_ref.keys()
    for k, p in out["params"].items():
        if k.split("/")[1] in ("conv1", "bn1", "layer1"):
            assert not out["grads"][k].any(), k
            assert torch.equal(p, new_ref[k]), k
            continue
        assert rel_err(out["grads"][k].numpy(), grads[k].numpy()) < 2e-3, k
        np.testing.assert_allclose(p.numpy(), new_ref[k].numpy(),
                                   atol=2 * LR, rtol=0, err_msg=k)
    ref = jax_tree(c["new_state"]["stats"])
    for k, v in out["stats"].items():
        assert rel_err(v.numpy(), ref[k].numpy()) < 1e-4, k

    opt = steps.make_optimizer(LR, 5.0)
    state = port_state(c["state"], opt)
    step = steps.make_tagger_train_step(TrainConfig(batch_size=2), opt,
                                        dropout_rate=0.0, arch=ARCH,
                                        device="cpu")
    step(state, {k: np.asarray(v)[:2] for k, v in c["batch"].items()})
    alone = by_path(state["stats"])
    assert max(rel_err(alone[k].numpy(), ref[k].numpy()) for k in ref) > \
        1e-2


def test_rematerialised_tagger_step_under_sync(ranks):
    """encoder_remat="blocks" recomputes each block's synchronised
    BatchNorm inside the backward, its all_reduces in the same order on
    every rank: the same gradients and statistics as without remat."""
    plain, remat = ranks[0][3], ranks[0][4]
    assert_replicas_equal(ranks, 4, ("params", "stats"))
    assert remat["metrics"] == plain["metrics"]
    for key in ("grads", "stats"):
        for k, v in plain[key].items():
            assert rel_err(remat[key][k].numpy(), v.numpy()) < 1e-5, (key, k)
