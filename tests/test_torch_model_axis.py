"""The port's model axis on four gloo ranks against the JAX package, on the
CPU.

Four processes (``tests/_torch_mesh_worker.py``, torchrun's environment)
form a (2, 2) mesh: each data row takes half of a global batch and each
model rank half of the vocabulary (fc's columns, the embedding's rows and
their Adam moments).  In one launch a mesh order, from weights bridged
from JAX (``models/jax_bridge.py``), dropout 0, they run:

* the frozen-encoder caption step, dense and chunked heads, in float32
  and bfloat16, against JAX's ``make_parallel_caption_train_step(...,
  shard_vocab=True)`` on ``make_mesh((2, 2))`` (``tests/test_sharding.py``'s
  ``[(4, 2), True]`` case at (2, 2)): every gradient elementwise within
  rtol 1e-4 and atol 1e-6 (a block against its slice of JAX's), the loss
  within 1e-5 relative; bfloat16 within ``tests/test_vocab_head.py``'s
  bf16 limits (the loss 5e-3 relative, the head's gradients, fc and the
  embedding, 3e-2 of each leaf's largest; all leaves together 3e-2 in
  the 2-norm: single elements of the bf16 scan's leaves stray further,
  in the one-rank port against JAX too).  JAX's gradients are read from its Adam's first moment after
  the step (mu = 0.1 g);
* the vocab-parallel chunked head alone against JAX's
  ``make_chunked_head_island`` at tiles 16 and 2,048 (past V/M: JAX's
  padded columns alias), as ``tests/test_vocab_head.py``'s island test;
* the placement tree of a state with Adam's moments against JAX's
  ``state_sharding`` (``tests/test_sharding.py``'s tree test), the
  shapes ``place_state`` leaves, and the refusal of a vocabulary the
  model axis does not divide (a ValueError naming both);
* the fine-tune step (one image a data row) against JAX's single-device
  step on both images (``tests/test_torch_finetune.py``'s case and
  tolerances; JAX's ``tests/test_mesh_training.py`` holds its
  partitioned fine-tune step to that one);
* the tagger step (two images a data row): the port's one-rank step on
  the four images, ``tests/test_torch_mesh.py``'s tolerances;
* the step's reducer on gradients that differ on every rank: blocks
  summed over the data group, the replicated leaves, the metrics and the
  running statistics the first model rank's.

Then the dense and chunked steps again with the ranks laid out
"colmajor".  Every rank of a data row ends with bitwise the same
replicated parameters, and every rank with the same loss.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from indonesian_image_captioning_tpu.core.config import \
    ModelConfig as JaxModelConfig
from indonesian_image_captioning_tpu.core.config import \
    TrainConfig as JaxTrainConfig
from indonesian_image_captioning_tpu.core.meshes import \
    make_mesh as jax_make_mesh
from indonesian_image_captioning_tpu.models import decoders as jax_decoders
from indonesian_image_captioning_tpu.ops.vocab_head import \
    chunked_ce_topk as jax_chunked_ce_topk
from indonesian_image_captioning_tpu.parallel import sharding as jax_sh
from indonesian_image_captioning_tpu.parallel.train_step import \
    make_parallel_caption_train_step as jax_parallel_step
from indonesian_image_captioning_tpu.train import steps as jax_steps
from indonesian_image_captioning_tpu_torch.core.config import (ModelConfig,
                                                               TaggerConfig,
                                                               TrainConfig)
from indonesian_image_captioning_tpu_torch.models import encoders
from indonesian_image_captioning_tpu_torch.models.jax_bridge import \
    params_from_jax
from indonesian_image_captioning_tpu_torch.parallel import sharding
from indonesian_image_captioning_tpu_torch.train import steps
from test_torch_finetune import CFG as FT_CFG
from test_torch_finetune import B as FT_B
from test_torch_finetune import jax_finetune_case  # noqa: F401 (fixture)
from test_torch_finetune import port_finetune_state
from test_torch_mesh import launch
from test_torch_tagger import by_path, rel_err
from _torch_tmp import tmp_path_factory  # noqa: F401 (fixtures)

torch.set_num_threads(1)
T, B, V = 8, 8, 40
KW = dict(model_type="attention_scn", vocab_size=V, embed_dim=16,
          attention_dim=12, decoder_dim=16, factored_dim=8, semantic_dim=10,
          encoder_dim=24, enc_image_size=2, max_caption_len=T + 1,
          dropout=0.0)
CAPLENS = [2, 8, 5, 3, 8, 6, 7, 4]
STEPS = [("dense", "float32"), ("chunked", "float32"),
         ("dense", "bfloat16"), ("chunked", "bfloat16")]
ISLAND = dict(B=8, T=7, D=16, V=64, tiles=(16, 2048))
TAGGER = {"semantic_size": 2, "encoder_arch": "resnet50", "dropout": 0.0}
VOCAB_LEAVES = ("fc/w", "fc/b", "embedding")


def caption_batch():
    rng = np.random.default_rng(6)
    return dict(enc=(rng.normal(size=(B, 2, 2, 24)) * 0.5).astype(np.float32),
                tags=rng.uniform(size=(B, 10)).astype(np.float32),
                caps=rng.integers(1, V, size=(B, T + 1)).astype(np.int32),
                caplens=np.asarray(CAPLENS, np.int32))


def torch_batch(b):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in b.items()}


def island_inputs():
    c = ISLAND
    rng = np.random.default_rng(0)
    fc = {"w": (rng.standard_normal((c["D"], c["V"])) * 0.2
                ).astype(np.float32),
          "b": (rng.standard_normal((c["V"],)) * 0.1).astype(np.float32)}
    hidden = (rng.standard_normal((c["B"], c["T"], c["D"])) * 0.5
              ).astype(np.float32)
    targets = rng.integers(0, c["V"], (c["B"], c["T"])).astype(np.int32)
    mask = (np.arange(c["T"])[None, :]
            < rng.integers(2, c["T"] + 1, (c["B"],))[:, None]
            ).astype(np.float32)
    return fc, hidden, targets, mask


def tagger_init():
    """A ResNet-50 tagger with its residual branches damped (bn3 scale
    x0.2; ``tests/test_torch_tagger.py`` says why) and a batch of four."""
    params, stats = encoders.init_encoder_tagger(
        torch.Generator().manual_seed(0), TaggerConfig(**TAGGER),
        arch="resnet50")
    for stage in ("layer1", "layer2", "layer3", "layer4"):
        st = params["resnet"][stage]
        for block in [st["first"], *st["rest"]]:
            block["bn3"]["scale"] = block["bn3"]["scale"] * 0.2
    rng = np.random.default_rng(4)
    batch = {"images": torch.from_numpy(
        rng.integers(0, 256, (4, 3, 32, 32)).astype(np.uint8)),
        "tags": torch.from_numpy((rng.random((4, 2)) < 0.5).astype(
            np.float32))}
    return params, stats, batch


@pytest.fixture(scope="module")
def jparams():
    return jax_decoders.init_decoder(jax.random.key(3), JaxModelConfig(**KW))


def step_cases(jparams, which):
    return [dict(case="caption_step", cfg=KW,
                 tcfg=dict(batch_size=B, head_impl=head, decoder_dtype=dt),
                 params=params_from_jax(jparams),
                 batch=torch_batch(caption_batch()))
            for head, dt in which]


@pytest.fixture(scope="module")
def rowmajor(tmp_path_factory, jparams, jax_finetune_case):  # noqa: F811
    fc, hidden, targets, mask = island_inputs()
    odd = jax_decoders.init_decoder(jax.random.key(3),
                                    JaxModelConfig(**{**KW, "vocab_size": 41}))
    c = jax_finetune_case
    state = port_finetune_state(c["state"], steps.make_optimizer(1e-3, 5.0),
                                steps.make_optimizer(1e-3, 5.0))
    tparams, tstats, tbatch = tagger_init()
    cases = step_cases(jparams, STEPS) + [
        dict(case="island", fc={k: torch.from_numpy(v) for k, v in
                                fc.items()},
             hidden=torch.from_numpy(hidden),
             targets=torch.from_numpy(targets).long(),
             mask=torch.from_numpy(mask), tiles=ISLAND["tiles"]),
        dict(case="placement", params=params_from_jax(jparams),
             odd_params=params_from_jax(odd)),
        dict(case="finetune_step", cfg=FT_CFG,
             tcfg=dict(batch_size=FT_B, fine_tune_encoder=True),
             state={k: v for k, v in state.items()
                    if k not in ("opt_state", "enc_opt_state")},
             batch=dict(images=torch.tensor(c["images"]),
                        tags=torch.tensor(c["tags"]),
                        caps=torch.tensor(c["caps"]).long(),
                        caplens=torch.tensor(c["caplens"]).long())),
        dict(case="tagger_step", tcfg=dict(batch_size=4, decoder_lr=1e-3),
             arch="resnet50", params=tparams, stats=tstats, batch=tbatch),
        dict(case="reducer", cfg=KW)]
    return launch(tmp_path_factory.mktemp("model_axis"),
                  {"cases": cases, "mesh": (2, 2)}, n=4)


@pytest.fixture(scope="module")
def colmajor(tmp_path_factory, jparams):
    return launch(tmp_path_factory.mktemp("model_axis_col"),
                  {"cases": step_cases(jparams, STEPS[:2]), "mesh": (2, 2),
                   "order": "colmajor"}, n=4)


def adam_mu(opt_state):
    """The first moment of the Adam inside JAX's optimizer chain."""
    inject = [s for s in opt_state if jax_steps.is_inject_state(s)][0]
    return [s for s in inject.inner_state if hasattr(s, "mu")][0].mu


@pytest.fixture(scope="module")
def jax_steps_out(jparams):
    """JAX's vocab-sharded (2, 2) step for each (head, dtype): its metrics
    and its clamped gradients (Adam's first moment / 0.1), by path."""
    out = {}
    mesh = jax_make_mesh((2, 2))
    b = caption_batch()
    for head, dt in STEPS:
        jcfg = JaxModelConfig(**KW)
        jtcfg = JaxTrainConfig(batch_size=B, head_impl=head,
                               decoder_dtype=dt)
        opt = jax_steps.make_optimizer(jtcfg.decoder_lr, jtcfg.grad_clip)
        params = jax.tree.map(jnp.copy, jparams)   # the step donates it
        sub = {"params": params, "opt_state": opt.init(params)}
        step = jax_parallel_step(jcfg, jtcfg, opt, mesh, sub,
                                 shard_vocab=True)
        full = jax_sh.state_sharding(mesh, sub, True)
        psub = jax.device_put(sub, {"params": full["params"],
                                    "opt_state": full["opt_state"]})
        data = jax_sh.batch_sharding_tree(mesh, b)
        placed = {k: jax.device_put(v, data[k]) for k, v in b.items()}
        new, m = step(psub, placed["enc"], placed["tags"], placed["caps"],
                      placed["caplens"], jax.random.key(0))
        grads = jax.tree.map(lambda x: np.asarray(x) / np.float32(0.1),
                             jax.device_get(adam_mu(new["opt_state"])))
        out[head, dt] = (jax.device_get(m), by_path(params_from_jax(grads)))
    return out


def block(ref, key, model_index, width):
    """The model rank's block of a whole leaf of JAX's tree."""
    if key == "fc/w":
        return ref[:, model_index * width:(model_index + 1) * width]
    if key in VOCAB_LEAVES:
        return ref[model_index * width:(model_index + 1) * width]
    return ref


def check_step(ranks, i, jm, jgrads, dt):
    width = V // 2
    for r in range(4):
        res = ranks[r][i]
        m = res["metrics"][0]
        rel = 1e-5 if dt == "float32" else 5e-3
        for k in ("loss", "ce", "alpha_penalty"):
            assert m[k] == pytest.approx(float(jm[k]), rel=rel), (r, k)
        assert m["n_tokens"] == float(jm["n_tokens"])
        if dt == "float32":
            assert m["top5"] == pytest.approx(float(jm["top5"]), abs=1e-4)
        assert res["grads"].keys() == jgrads.keys()
        flat = []
        for k, g in res["grads"].items():
            ref = block(jgrads[k], k, res["coords"]["model"], width).numpy()
            assert g.shape == ref.shape, k
            if dt == "float32":
                np.testing.assert_allclose(g.numpy(), ref, rtol=1e-4,
                                           atol=1e-6, err_msg=f"{r} {k}")
            elif k in VOCAB_LEAVES:
                assert rel_err(g.numpy(), ref) < 3e-2, (r, k)
            flat.append((g.numpy().ravel(), ref.ravel()))
        if dt != "float32":
            # the bf16 scan's own leaves: bf16 rounding in a recurrence
            # moves single elements of a leaf past 3e-2 of its largest in
            # the one-rank port against JAX too; all leaves together
            a, b = (np.concatenate(x).astype(np.float64)
                    for x in zip(*flat))
            assert np.linalg.norm(a - b) / np.linalg.norm(b) < 3e-2, r
    for r in range(1, 4):
        for k, v in ranks[r][i]["params"].items():
            if k not in VOCAB_LEAVES:
                assert torch.equal(v, ranks[0][i]["params"][k]), (r, k)


@pytest.mark.parametrize("head,dt", STEPS)
def test_step_matches_jax_vocab_sharded(rowmajor, jax_steps_out, head, dt):
    """Each rank's gradients (its vocabulary block's against the matching
    slice) and the global metrics equal JAX's vocab-sharded (2, 2) step;
    every rank holds the same replicated parameters."""
    i = STEPS.index((head, dt))
    check_step(rowmajor, i, *jax_steps_out[head, dt], dt)


def test_reducer_gives_every_model_rank_the_first_ones_replicas(rowmajor):
    """Gradients that differ on every rank: a vocabulary block's sum over
    its data group (its model column); a replicated leaf's and the
    metrics' the data sum of model column 0 on every rank, as the running
    statistics are model column 0's, so the M replicas of a data row
    cannot drift apart whatever the backward's determinism; a frozen
    leaf keeps no gradient; whole vocabulary leaves on a model axis (a
    state not placed) raise."""
    out = [rowmajor[r][len(STEPS) + 4] for r in range(4)]
    col = {m: [r for r in range(4) if out[r]["coords"]["model"] == m]
           for m in (0, 1)}

    def rep(r):
        return torch.tensor([1.0, 10.0, 100.0]) * (r + 1) + 0.25 * r

    for r in range(4):
        res = out[r]
        d, m = res["coords"]["data"], res["coords"]["model"]
        assert torch.equal(res["blk"], sum(torch.tensor([1.0, 2.0]) * (q + 1)
                                           for q in col[m])), r
        assert torch.equal(res["rep"], sum(rep(q) for q in col[0])), r
        assert res["extra"] == [float(sum(q + 1 for q in col[0]))], r
        assert res["frozen"] is None
        first = [q for q in range(4) if out[q]["coords"] == {
            "data": d, "model": 0}][0]
        assert torch.equal(res["stats"], torch.full((2,), float(first))), r
        assert "vocab_size 6" in res["refusal"], res["refusal"]


@pytest.mark.parametrize("head", ["dense", "chunked"])
def test_step_matches_jax_colmajor(colmajor, jax_steps_out, head):
    """The same under the "colmajor" layout (a model row's ranks
    strided), whose groups differ from rowmajor's."""
    i = ["dense", "chunked"].index(head)
    # rank (d, m) = m * D + d
    assert [(r[i]["coords"]["data"], r[i]["coords"]["model"])
            for r in colmajor] == [(0, 0), (1, 0), (0, 1), (1, 1)]
    check_step(colmajor, i, *jax_steps_out[head, "float32"], "float32")


@pytest.mark.parametrize("tile", ISLAND["tiles"])
def test_island_matches_jax(rowmajor, tile):
    """The vocab-parallel chunked head (its (max, exp-sum, target logit,
    rank count) merged over the model group, d_h summed by
    ``enter_vocab_region``) against JAX's island and its one-device
    chunked head: CE within 1e-5, gradients rtol 1e-4 and atol 1e-6."""
    from indonesian_image_captioning_tpu.train.steps import \
        make_chunked_head_island
    fc, hidden, targets, mask = (jax.tree.map(jnp.asarray, x)
                                 for x in island_inputs())
    island = make_chunked_head_island(jax_make_mesh((2, 2)), tile=tile)

    def loss(fc, hidden):
        return island(fc, hidden, targets, mask)[0]

    v, g = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))(fc, hidden)
    _, topk, _ = island(fc, hidden, targets, mask)
    plain = jax_chunked_ce_topk(fc, hidden, targets, mask, tile=16)
    width, rows = ISLAND["V"] // 2, ISLAND["B"] // 2
    i = len(STEPS)
    for r in range(4):
        res = rowmajor[r][i]
        d, m = res["coords"]["data"], res["coords"]["model"]
        out = res[tile]
        assert abs(out["ce"] - float(v)) < 1e-5
        assert abs(out["ce"] - float(plain[0])) < 1e-5
        assert out["topk"] == pytest.approx(float(topk), abs=1e-4)
        cols = slice(m * width, (m + 1) * width)
        np.testing.assert_allclose(out["d_w"].numpy(),
                                   np.asarray(g[0]["w"])[:, cols],
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(out["d_b"].numpy(),
                                   np.asarray(g[0]["b"])[cols],
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(out["d_h"].numpy(),
                                   np.asarray(g[1])[d * rows:(d + 1) * rows],
                                   rtol=1e-4, atol=1e-6)


def test_placement_matches_jax_and_refuses_uneven_vocab(rowmajor, jparams):
    """state_sharding's tree is JAX's (fc.w over (None, "model"), fc.b and
    the embedding's rows over "model", Adam's moments as their leaves,
    the rest replicated); place_state leaves V/M-wide blocks; a vocabulary
    of 41 on a model axis of 2 raises a ValueError naming both."""
    jopt = jax_steps.make_optimizer(4e-4, 5.0)
    jtree = jax_sh.state_sharding(jax_make_mesh((2, 2)),
                                  {"params": jparams,
                                   "opt_state": jopt.init(jparams)},
                                  shard_vocab=True)
    leaves = jax.tree_util.tree_flatten_with_path(
        jtree["params"], is_leaf=lambda s: hasattr(s, "spec"))[0]
    want = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(s.spec) for path, s in leaves}
    assert tuple(adam_mu(jtree["opt_state"])["fc"]["w"].spec) == (None,
                                                                 "model")
    params = params_from_jax(jparams)
    order = list(by_path(params))
    for r in range(4):
        res = rowmajor[r][len(STEPS) + 1]
        got = by_path(res["tree"]["params"])
        assert got.keys() == want.keys()
        for k in got:
            assert got[k] == want[k], k
        moments = res["tree"]["opt_state"]["state"]
        for k, spec in want.items():
            idx = order.index(k)
            assert moments[idx]["exp_avg"] == spec, k
            assert moments[idx]["exp_avg_sq"] == spec, k
            assert moments[idx]["step"] == sharding.REPLICATED
        shapes = res["shapes"]
        assert shapes["fc/w"] == (KW["decoder_dim"], V // 2)
        assert shapes["fc/b"] == (V // 2,)
        assert shapes["embedding"] == (V // 2, KW["embed_dim"])
        for k in ("fc/w", "fc/b", "embedding"):
            assert res["moments"][order.index(k)] == (shapes[k],) * 2
        for key in ("refusal", "trainer_refusal"):
            assert "vocab_size 41" in res[key] and "model axis 2" in \
                res[key], res.get(key)


def test_finetune_step_at_2x2_matches_jax(rowmajor,
                                          jax_finetune_case):  # noqa: F811
    """One image a data row, the model ranks repeating it: the (2, 2)
    fine-tune step equals JAX's step on both images; synchronised
    BatchNorm reduces over the data group only (over every rank it would
    count each image twice); every rank ends with bitwise the same
    replicated parameters, encoder and statistics."""
    c = jax_finetune_case
    i = len(STEPS) + 2
    lrs = {"params": 4e-4, "encoder": 1e-4}
    width = FT_CFG["vocab_size"] // 2
    stats_ref = by_path(params_from_jax(c["new"]["encoder_stats"]))
    for r in range(4):
        out = rowmajor[r][i]
        mi = out["coords"]["model"]
        for k in ("loss", "ce", "alpha_penalty"):
            assert out["metrics"][k] == pytest.approx(
                float(c["metrics"][k]), rel=1e-4), k
        for tree, opt_key in (("params", "opt_state"),
                              ("encoder", "enc_opt_state")):
            grads = by_path(params_from_jax(c["new"][opt_key][1]))
            new_ref = by_path(params_from_jax(c["new"][tree]))
            for k, p in out[tree].items():
                ref_p = block(new_ref[k], k, mi, width) if tree == \
                    "params" else new_ref[k]
                if k in out[tree + "_grads"]:
                    ref = (block(grads[k], k, mi, width) if tree == "params"
                           else grads[k]).numpy()
                    g = out[tree + "_grads"][k].numpy()
                    assert float(np.abs(g - ref).max()) <= max(
                        2e-3 * float(np.abs(ref).max()), 1e-6), (r, tree, k)
                np.testing.assert_allclose(p.numpy(), ref_p.numpy(),
                                           atol=2 * lrs[tree], rtol=0,
                                           err_msg=f"{r} {tree}/{k}")
        for k, v in out["stats"].items():
            assert rel_err(v.numpy(), stats_ref[k].numpy()) < 1e-4, k
        for tree in ("params", "encoder", "stats"):
            for k, v in out[tree].items():
                if tree != "params" or k not in VOCAB_LEAVES:
                    assert torch.equal(v, rowmajor[0][i][tree][k]), (r, k)


def test_tagger_step_at_2x2(rowmajor):
    """Two images a data row, the model ranks repeating them: the (2, 2)
    tagger step equals the one-rank step on the four images
    (``tests/test_torch_mesh.py``'s tolerances); every rank ends with
    bitwise the same parameters and statistics."""
    i = len(STEPS) + 3
    params, stats, batch = tagger_init()
    tcfg = TrainConfig(batch_size=4, decoder_lr=1e-3)
    opt = steps.make_optimizer(1e-3, 5.0)
    state = {"params": params, "stats": stats,
             "opt_state": opt.init(params)}
    step = steps.make_tagger_train_step(tcfg, opt, dropout_rate=0.0,
                                        arch="resnet50", device="cpu")
    _, m = step(state, batch)
    grads = {k: v.grad for k, v in by_path(state["params"]).items()}
    ref_stats = by_path(state["stats"])
    for r in range(4):
        out = rowmajor[r][i]
        assert out["metrics"]["loss"] == pytest.approx(float(m["loss"]),
                                                       rel=1e-4)
        for k, g in out["grads"].items():
            assert rel_err(g.numpy(), grads[k].numpy()) < 2e-3, k
        for k, v in out["stats"].items():
            assert rel_err(v.numpy(), ref_stats[k].numpy()) < 1e-4, k
        for key in ("params", "stats"):
            for k, v in out[key].items():
                assert torch.equal(v, rowmajor[0][i][key][k]), (r, key, k)


def test_head_resolves_on_the_global_batch(monkeypatch):
    """At D = 2 and V = 38,732 a global batch whose logits cross 2^27
    while each rank's rows do not resolves "auto" to "chunked" on CUDA;
    the train and eval steps under a mesh hand the resolver the global
    batch's rows (a rank's rows times D), as JAX's partitioned step sees
    them."""
    cfg = ModelConfig(vocab_size=38_732)
    tcfg = TrainConfig(head_impl="auto")
    per_row = (cfg.max_caption_len - 1) * cfg.vocab_size
    rows = 64                               # a rank's rows
    assert rows * per_row < 1 << 27 <= 2 * rows * per_row
    cuda = torch.device("cuda")
    assert steps.resolve_head_impl(tcfg, cfg, rows, cuda) == "dense"
    assert steps.resolve_head_impl(tcfg, cfg, 2 * rows, cuda) == "chunked"
    assert steps.resolve_head_impl(tcfg, cfg, 2 * rows,
                                   torch.device("cpu")) == "dense"

    # a (2, 1) layout whose collectives are the identity (no groups)
    from indonesian_image_captioning_tpu_torch.core import meshes
    from indonesian_image_captioning_tpu_torch.models import decoders
    mesh = meshes.Mesh(np.arange(2).reshape(2, 1), 0, 0, 0, None, None,
                       None)
    seen = []
    resolve = steps.resolve_head_impl
    monkeypatch.setattr(steps, "resolve_head_impl",
                        lambda t, c, batch, dev: seen.append(batch)
                        or resolve(t, c, batch, dev))
    small = ModelConfig(**KW)
    params = decoders.init_decoder(torch.Generator().manual_seed(0), small)
    opt = steps.make_optimizer(4e-4, 5.0)
    b = torch_batch({k: v[:3] for k, v in caption_batch().items()})
    _, step = steps.make_caption_train_step(small, tcfg, opt, device="cpu",
                                            mesh=mesh)
    step({"params": params, "opt_state": opt.init(params)}, b["enc"],
         b["tags"], b["caps"], b["caplens"])
    _, evaluate = steps.make_caption_eval_step(small, tcfg, device="cpu",
                                               mesh=mesh)
    evaluate(params, b["enc"], b["tags"], b["caps"], b["caplens"])
    assert seen == [6, 6]
