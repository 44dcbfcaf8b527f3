"""The plain reference against the port's CPU paths, at tiny widths and
float32: the decoders' teacher-forced logits, a beam decode judged by
``reference/beam.py``, and the train step.  These tests import the port;
the reference itself imports nothing of it (test_portbench_imports.py).

    python -m pytest portbench/tests -q
"""

import pytest
import torch

from indonesian_image_captioning_tpu_torch.core.config import (
    BeamConfig, ModelConfig, TrainConfig)
from indonesian_image_captioning_tpu_torch.decode.api import \
    caption_beam_search
from indonesian_image_captioning_tpu_torch.models import decoders
from indonesian_image_captioning_tpu_torch.train import steps
from portbench import weights
from portbench.reference import beam
from portbench.reference.decoder import Decoder, as_f32
from portbench.reference.train import TrainReference, leaf_gaps
from portbench.work import Model

FAMILIES = ("attention_scn", "pure_attention")
TINY = dict(vocab_size=40, embed_dim=16, attention_dim=12, decoder_dim=16,
            factored_dim=8, semantic_dim=10, encoder_dim=24,
            enc_image_size=3, max_caption_len=9)
LENGTHS = {"bands": [[3, 9, 1.0]]}


def _model(family):
    return {"model_type": family, **TINY}


def _inputs(model, n, seed):
    m = Model.of(model)
    params = weights.make_decoder(m, seed, torch.float32, "cpu")
    enc, tags = weights.features(m, n, seed + 1, 0.5, torch.float32, "cpu")
    return m, params, enc.reshape(n, -1, m.encoder_dim), tags


@pytest.mark.parametrize("family", FAMILIES)
def test_layout_is_the_ports(family):
    """The benchmark's seeded tree has the port's names and shapes."""
    cfg = ModelConfig(**_model(family))
    port = decoders.init_decoder(torch.Generator().manual_seed(0), cfg)
    ours = weights.make_decoder(Model.of(_model(family)), 0, torch.float32,
                                "cpu")
    assert [(n, tuple(t.shape)) for n, t in weights.leaves(port)] == \
        [(n, tuple(t.shape)) for n, t in weights.leaves(ours)]


@pytest.mark.parametrize("family", FAMILIES)
def test_teacher_forced_logits_match_the_port(family):
    model = _model(family)
    m, params, enc, tags = _inputs(model, 5, 11)
    caps, lens = weights.captions(m, 5, 12, LENGTHS, "cpu")
    cfg = ModelConfig(**model, dropout=0.0)
    T = m.max_caption_len - 1
    want = decoders.teacher_forcing(params, cfg, enc, tags, caps, lens)
    got, alphas = Decoder(as_f32(params), model).teacher_forced(
        enc, tags, caps, T)
    torch.testing.assert_close(got, want["predictions"], atol=1e-5,
                               rtol=1e-5)
    torch.testing.assert_close(alphas, want["alphas"], atol=1e-6,
                               rtol=1e-5)


@pytest.mark.parametrize("family", FAMILIES)
def test_a_float32_decode_of_the_port_passes_the_judgement(family):
    """The port's float32 beam decode: every token among the reference's
    K best of its prefix (to rounding), every score the reference's sum,
    nothing misshapen."""
    model = _model(family)
    m, params, enc, tags = _inputs(model, 6, 21)
    V, T = m.vocab_size, 8
    out = caption_beam_search(params, ModelConfig(**model), enc, tags,
                              start_id=V - 2, end_id=V - 1,
                              beam_cfg=BeamConfig(beam_size=3, max_steps=T))
    gap, err, bad = beam.judge(Decoder(params, model), enc, tags,
                               out["sequences"], out["lengths"],
                               out["scores"], beam=3, start_id=V - 2,
                               end_id=V - 1, max_steps=T, vocab=V)
    assert float(gap.max()) <= 1e-5
    assert float(err.max()) <= 1e-4
    assert not bool(bad.any())


def test_the_judgement_finds_an_altered_token_and_a_wrong_score():
    model = _model("attention_scn")
    m, params, enc, tags = _inputs(model, 6, 31)
    V, T = m.vocab_size, 8
    out = caption_beam_search(params, ModelConfig(**model), enc, tags,
                              start_id=V - 2, end_id=V - 1,
                              beam_cfg=BeamConfig(beam_size=3, max_steps=T))
    dec = Decoder(params, model)
    kw = dict(beam=3, start_id=V - 2, end_id=V - 1, max_steps=T, vocab=V)
    logits, _ = dec.teacher_forced(enc, tags, out["sequences"].long(), 1)
    worst = logits[:, 0].argmin(-1)
    seqs = out["sequences"].clone()
    seqs[:, 1] = worst.to(seqs.dtype)
    gap, err, _ = beam.judge(dec, enc, tags, seqs, out["lengths"],
                             out["scores"], **kw)
    assert bool((gap > 1e-3).all()) and bool((err > 1e-3).all())
    _, err, _ = beam.judge(dec, enc, tags, out["sequences"], out["lengths"],
                           out["scores"] + 0.5, **kw)
    assert bool((err > 0.4).all())
    lens = out["lengths"].clone()
    lens[0] = 1
    *_, bad = beam.judge(dec, enc, tags, out["sequences"], lens,
                         out["scores"], **kw)
    assert bool(bad[0]) and not bool(bad[1:].any())


@pytest.mark.parametrize("family", FAMILIES)
def test_three_float32_train_steps_match_the_port(family):
    """Loss, clamped gradients and Adam's update of three steps of the
    port's float32 train step (eager scan, dense head) against the
    reference's, in blocks smaller than the batch."""
    model = _model(family)
    m, params, _, _ = _inputs(model, 1, 41)
    B = 8
    train = {"decoder_lr": 4e-3, "grad_clip": 0.05, "alpha_c": 1.0,
             "decoder_dtype": "float32"}
    cfg = ModelConfig(**model, dropout=0.0)
    tcfg = TrainConfig(batch_size=B, decoder_lr=train["decoder_lr"],
                       grad_clip=train["grad_clip"])
    p0 = {k: v for k, v in as_f32(params).items()}
    opt = steps.make_optimizer(train["decoder_lr"], train["grad_clip"])
    state = {"params": params, "opt_state": opt.init(params)}
    _, step = steps.make_caption_train_step(cfg, tcfg, opt, device="cpu")
    ref = TrainReference(p0, model, train, block=3)
    for i in range(3):
        enc, tags = weights.features(m, B, 50 + i, 0.5, torch.float32, "cpu")
        caps, lens = weights.captions(m, B, 60 + i, LENGTHS, "cpu")
        metrics = step(state, enc, tags, caps, lens)[1]
        loss, grads = ref.step(enc, tags, caps, lens)
        assert abs(float(metrics["loss"]) - loss) <= 1e-5 * abs(loss)
        if i == 0:
            moments = state["opt_state"].state
            g1 = [moments[p]["exp_avg"] / 0.1
                  for _, p in weights.leaves(params)]
            assert max(leaf_gaps(g1, grads)) <= 1e-4
            norms = torch.stack([g.norm() for g in grads])
            moved = norms >= 1e-3 * norms.median()
    # full_att's bias has no gradient in exact arithmetic (the softmax
    # drops it) and moves under Adam by round-off alone
    mine = [p for _, p in weights.leaves(params)]
    theirs = [p for _, p in weights.leaves(ref.params)]
    assert int((~moved).sum()) <= 1
    for a, b, keep in zip(mine, theirs, moved.tolist()):
        if keep:
            torch.testing.assert_close(a.detach(), b, atol=1e-5, rtol=1e-4)


def test_leaf_gaps_measure_against_the_median_leaf():
    ref = [torch.ones(4), torch.ones(4) * 2, torch.full((4,), 1e-9)]
    prog = [torch.ones(4), torch.ones(4) * 3, torch.zeros(4)]
    gaps = leaf_gaps(prog, ref)
    assert gaps[0] == 0.0
    assert gaps[1] == pytest.approx(0.5)
    assert gaps[2] == pytest.approx(1e-9, rel=1e-6)


def test_a_resnet_calibrated_and_run_matches_the_port():
    """ResNet-50 at 32 px, float32: the statistics of a calibrating pass,
    then the caption encoder's pooled features and the tagger's
    probabilities, against the port's encoders."""
    from indonesian_image_captioning_tpu_torch.models import encoders
    from portbench.reference import resnet

    params, stats = weights.make_resnet("resnet50", 5, "cpu")
    images = torch.from_numpy(weights.images(4, 32, 6))
    x = encoders.prep_images(images)
    want, new = encoders.apply_encoder_caption(
        {"resnet": params}, {"resnet": stats}, x, train="calibrate",
        enc_image_size=3, arch="resnet50")
    ref_stats = resnet.ResNet(params).calibrate(resnet.normalise(images))
    mine = [t for _, t in _flat(ref_stats)]
    theirs = [t for _, t in _flat(new["resnet"])]
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    net = resnet.ResNet(params, ref_stats)
    enc, _ = encoders.apply_encoder_caption(
        {"resnet": params}, new, x, enc_image_size=3, arch="resnet50")
    got = resnet.caption_features(net, resnet.normalise(images), 3)
    torch.testing.assert_close(got, enc.reshape(4, 9, -1), atol=1e-4,
                               rtol=1e-4)
    lin = {"w": torch.randn(2048, 10) * 0.02, "b": torch.zeros(10)}
    tags, _ = encoders.apply_encoder_tagger(
        {"resnet": params, "linear": lin}, new, x, arch="resnet50")
    torch.testing.assert_close(
        resnet.tag_probabilities(net, lin, resnet.normalise(images)), tags,
        atol=1e-5, rtol=1e-4)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _flat(v, f"{prefix}/{k}")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in _flat(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


def test_caption_strings_are_rebuilt_and_judged():
    """A float32 decode of the port, detokenised as the caption service
    does (dropping <start>, <end> and <pad>, which a small vocabulary's
    random head emits), is rebuilt token for token by judge_words with
    every gap at zero; a changed word is found."""
    model = _model("attention_scn")
    m, params, enc, tags = _inputs(model, 12, 71)
    V, T = m.vocab_size, 8
    out = caption_beam_search(params, ModelConfig(**model), enc, tags,
                              start_id=V - 2, end_id=V - 1,
                              beam_cfg=BeamConfig(beam_size=3, max_steps=T))
    skip = (0, V - 2)
    words = [[int(w) for w in seq[1:int(n)] if int(w) not in skip + (V - 1,)]
             for seq, n in zip(out["sequences"], out["lengths"])]
    dropped = sum(int(w) in skip for seq, n in zip(out["sequences"],
                                                   out["lengths"])
                  for w in seq[1:int(n)])
    assert dropped > 0             # the seed emits dropped ids to rebuild
    dec = Decoder(params, model)
    kw = dict(beam=3, start_id=V - 2, end_id=V - 1, skip_ids=skip,
              max_steps=T)
    gap, seqs, lens, bad = beam.judge_words(dec, enc, tags, words, **kw)
    assert float(gap.max()) <= 1e-5 and not bool(bad.any())
    assert torch.equal(lens, out["lengths"].long())
    # where two rebuilds both hold (a dropped id and a word each among
    # the K best at both places) either may come back; the words agree
    for seq, n, w in zip(seqs.tolist(), lens.tolist(), words):
        assert [t for t in seq[1:n] if t not in skip + (V - 1,)] == w
    words[0][0] = (words[0][0] + V // 2) % (V - 3) + 1
    gap, *_ = beam.judge_words(dec, enc, tags, words, **kw)
    assert float(gap[0]) > 1e-3
