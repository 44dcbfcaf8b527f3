"""The port's beam decode at bfloat16 against the JAX package's, on the CPU.

``caption_beam_search`` with ``ModelConfig(dtype="bfloat16")`` and every
parameter cast to bfloat16, as the JAX benchmark's decode mode runs it:
each rung name of the port ("steps", and the fused rungs, whose kernels
run their plain versions on CPU tensors) against JAX's decode under the
same name (its Pallas kernels in interpret mode), for both attention
families.  Weights and inputs are seeded with numpy; the head is drawn
wider than the initialiser's and leans toward <end>, so that images end
at different steps.

What must match: the sequences and lengths, except on rows where the
port's best beam and JAX's differ but score within NEAR_TIE of each other
(a near-tie, which bf16 rounding may resolve either way), and at most
MAX_FLAGGED of the B rows may be flagged so; the scores of every other row within SCORE_TOL,
a little over one bf16 ulp of a log-probability between 2 and 4 (2^-6):
"steps" sums the same bf16 log-probabilities as JAX in float32 (measured
0 apart for attention_scn; pure_attention's LSTM state rounds one
log-probability an ulp away on two images, 0.0156); the fused rungs take
float32 candidates from a bf16 state whose roundings differ from JAX's
interpret-mode kernels by an ulp here and there (measured up to 0.0085
over 16 steps).  The port at float32 on the same inputs reads 0.043 on
"steps" (attention_scn), and the step engine's former lowest-id order
among equal bf16 log-probabilities ended three of eight images a step
late (3.66 apart).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from indonesian_image_captioning_tpu.core.config import BeamConfig, ModelConfig
from indonesian_image_captioning_tpu.decode.api import \
    caption_beam_search as jax_caption_beam_search
from indonesian_image_captioning_tpu.models import decoders as jax_decoders
from indonesian_image_captioning_tpu_torch.decode.api import \
    caption_beam_search
from indonesian_image_captioning_tpu_torch.models import decoders
from indonesian_image_captioning_tpu_torch.models.jax_bridge import \
    params_from_jax

torch.set_num_threads(1)
B, K, T, V = 8, 5, 16, 40
END_BIAS = 0.6
SCORE_TOL = 0.02
NEAR_TIE = 0.05
MAX_FLAGGED = 2
RUNGS = ("steps", "fused_step", "fused_span", "fused")


def bf16(x):
    return jnp.asarray(x).astype(jnp.bfloat16)


def to_torch(x):
    """A JAX bf16 array as a torch bf16 tensor (exact: through float32)."""
    return torch.from_numpy(np.array(jnp.asarray(x).astype(jnp.float32))
                            ).to(torch.bfloat16)


def decode_case(model_type, wide_head=True):
    """cfg, bf16 parameters, encodings and tags; wide_head draws the head
    wider than the initialiser's, leaning toward <end>."""
    cfg = ModelConfig(model_type=model_type, vocab_size=V, embed_dim=16,
                      attention_dim=16, decoder_dim=16, factored_dim=8,
                      semantic_dim=11, encoder_dim=32, enc_image_size=3,
                      dtype="bfloat16")
    rng = np.random.default_rng(7)
    params = jax_decoders.init_decoder(jax.random.key(3), cfg)
    fc_b = rng.normal(size=(V,)).astype(np.float32) * 0.5
    fc_b[V - 1] = END_BIAS
    fc_w = rng.normal(size=(cfg.decoder_dim, V)).astype(np.float32) * 0.5
    if wide_head:
        params["fc"] = {"w": fc_w, "b": fc_b}
    params = jax.tree.map(bf16, params)
    enc = bf16(rng.normal(size=(B, 9, 32)).astype(np.float32) * 2.0)
    tags = bf16(rng.uniform(size=(B, 11)).astype(np.float32))
    return cfg, params, enc, tags


_JAX = {}


def jax_reference(model_type, rung):
    """JAX's decode of decode_case under the rung's name (cached: the
    interpret-mode kernels take seconds)."""
    if (model_type, rung) not in _JAX:
        cfg, params, enc, tags = decode_case(model_type)
        out = jax_caption_beam_search(
            params, dataclasses.replace(cfg, decode_impl=rung), enc, tags,
            start_id=V - 2, end_id=V - 1,
            beam_cfg=BeamConfig(beam_size=K, max_steps=T))
        _JAX[model_type, rung] = {k: np.asarray(out[k]) for k in (
            "sequences", "lengths", "scores")}
    return _JAX[model_type, rung]


def port_decode(model_type, rung, dtype=torch.bfloat16):
    cfg, params, enc, tags = decode_case(model_type)
    tp = decoders.cast_params(params_from_jax(params), dtype)
    return caption_beam_search(
        tp, dataclasses.replace(cfg, decode_impl=rung),
        to_torch(enc).to(dtype), to_torch(tags).to(dtype), start_id=V - 2,
        end_id=V - 1, beam_cfg=BeamConfig(beam_size=K, max_steps=T))


def compare_beams(out, ref):
    """(rows flagged as near-ties, largest score error on the others);
    asserts the near-tie rule."""
    seqs, lens = out["sequences"].numpy(), out["lengths"].numpy()
    scores = out["scores"].float().numpy()
    flagged, worst = [], 0.0
    for i in range(B):
        same = lens[i] == ref["lengths"][i] and np.array_equal(
            seqs[i], ref["sequences"][i])
        if same:
            worst = max(worst, abs(float(scores[i] - ref["scores"][i])))
            continue
        gap = abs(float(scores[i] - ref["scores"][i]))
        assert gap <= NEAR_TIE, (
            f"image {i}: beams differ with scores {gap} apart (near-tie "
            f"limit {NEAR_TIE}): {seqs[i].tolist()} vs "
            f"{ref['sequences'][i].tolist()}")
        flagged.append(i)
    assert len(flagged) <= MAX_FLAGGED, f"near-ties on rows {flagged}"
    return flagged, worst


@pytest.mark.parametrize("rung", RUNGS)
@pytest.mark.parametrize("model_type", ["attention_scn", "pure_attention"])
def test_bf16_beam_decode_matches_jax_under_each_rung(model_type, rung):
    """Each rung's bf16 beams against JAX's under the same name: sequences
    and lengths equal but at near-ties, scores within SCORE_TOL, and the
    images end at different steps (the pools and the early exit run)."""
    ref = jax_reference(model_type, rung)
    out = port_decode(model_type, rung)
    want = rung if not (rung == "fused" and model_type != "attention_scn") \
        else "steps"
    assert out["decode_impl"] == want
    assert out["scores"].dtype == torch.float32
    assert len(set(ref["lengths"].tolist())) > 1, ref["lengths"]
    flagged, worst = compare_beams(out, ref)
    assert worst <= SCORE_TOL, f"score error {worst} > {SCORE_TOL}"


def test_bf16_sparse_head_orders_equal_log_probs_by_their_logits():
    """The step engine's per-lane top-K at bf16: log-probabilities that
    round to one bf16 value keep their logits' order, as JAX's fused
    log-softmax and top-K rank them (XLA keeps float32 there), not the
    lowest id's; the values are the bf16 log-softmax's.  The initialiser's
    narrow head puts many of a lane's best logits within one bf16 ulp of
    log V."""
    cfg, params, enc, tags = decode_case("attention_scn", wide_head=False)
    tp = params_from_jax(params)
    init, step = decoders.make_beam_step(tp, cfg, to_torch(enc),
                                         to_torch(tags))
    start = torch.full((B, K), V - 2, dtype=torch.int64)
    (vals, ids), state, _ = step(init(K), start)
    logits = (state["h"] @ tp["fc"]["w"] + tp["fc"]["b"]).float()
    logp = torch.log_softmax(state["h"] @ tp["fc"]["w"] + tp["fc"]["b"],
                             dim=-1)
    order = torch.argsort(-logits.double() + torch.arange(V) * 1e-9, dim=-1)
    assert vals.dtype == torch.bfloat16
    assert torch.equal(ids.long(), order[..., :K])
    assert torch.equal(vals, torch.gather(logp, -1, ids.long()))
    # ties: in most lanes two of the K picks share one bf16 value, and
    # the lowest id among them is not always first
    assert (vals[..., 1:] == vals[..., :-1]).any(-1).float().mean() > 0.5
    assert not torch.equal(ids.long(), torch.sort(ids.long(), -1).values)


@pytest.mark.parametrize("model_type", ["attention_scn", "pure_attention"])
def test_span_records_plain_loop_is_the_wrappers_cpu_path(model_type):
    """span_cuda.beam_decode_span_records_plain, the whole decode through
    kernel 7's plain version on any device (what chip_smoke.py holds the
    kernel's decode against on the card), gives on CPU tensors exactly
    the records of beam_decode_span_records, whose wrapper takes the
    plain version there."""
    from indonesian_image_captioning_tpu_torch.ops import span_cuda
    cfg, params, enc, tags = decode_case(model_type)
    tp, te, tt = params_from_jax(params), to_torch(enc), to_torch(tags)
    kw = dict(beam_size=K, start_id=V - 2, end_id=V - 1, max_steps=T,
              span=cfg.decode_span)
    got = span_cuda.beam_decode_span_records_plain(tp, cfg, te, tt, **kw)
    want = span_cuda.beam_decode_span_records(tp, cfg, te, tt, **kw)
    assert got["calls"] == want["calls"] == -(-T // cfg.decode_span)
    for k in ("words", "parents", "vals"):
        assert torch.equal(got[k], want[k]), k
