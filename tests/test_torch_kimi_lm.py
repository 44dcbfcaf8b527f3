"""Kimi-VL-A3B's language model as a caption decoder (``models/kimi_lm.py``,
``ops/lm_cuda.py``'s plain versions) against the plain reference
(``tests/plain_kimi_lm.py``) at tiny widths on the CPU, float32: hidden
64, 4 heads, latent 32, rope 16, 8 routed experts top 2, 1 shared, 3
layers (one dense), V = 97.

Tolerances: the port's float32 and the reference's float32 differ only in
the order of their sums (the absorbed attention multiplies W_UK into the
query where the reference decompresses every key; the experts' rows
are gathered in another order), a few ulps of values of order 10:
2e-4 absolute on logits, 1e-5 on a layer's output.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from indonesian_image_captioning_tpu_torch.core.config import BeamConfig
from indonesian_image_captioning_tpu_torch.decode import beam
from indonesian_image_captioning_tpu_torch.decode.api import \
    caption_beam_search
from indonesian_image_captioning_tpu_torch.models import encoders, kimi_lm
from indonesian_image_captioning_tpu_torch.ops import lm_cuda
from indonesian_image_captioning_tpu_torch.serve import (CaptionEngine,
                                                         ServeConfig)

sys.path.insert(0, str(Path(__file__).resolve().parent))
from kimi_lm_weights import init_params  # noqa: E402
from plain_kimi_lm import KimiLM  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TINY = kimi_lm.KimiLMConfig(
    vocab_size=97, hidden_size=64, intermediate_size=96,
    moe_intermediate_size=32, num_hidden_layers=3, num_attention_heads=4,
    n_shared_experts=1, n_routed_experts=8, num_experts_per_tok=2,
    kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=16,
    v_head_dim=16, encoder_dim=24, enc_image_size=3)
START, END = 95, 96
LOGIT_TOL = 2e-4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(seed=0, n=2, cfg=TINY):
    params = init_params(torch.Generator().manual_seed(seed), cfg)
    enc = torch.randn((n, cfg.num_pixels, cfg.encoder_dim),
                      generator=torch.Generator().manual_seed(seed + 1))
    return params, enc


def _ref(params, cfg=TINY):
    return KimiLM(params, dataclasses.asdict(cfg))


def test_prefill_then_cached_decode_matches_the_full_forward():
    """Prefill, then steps through the cache with each lane's own words:
    the logits of every step equal the reference's full forward over the
    same tokens."""
    params, enc = _setup()
    B, K, T = 2, 3, 6
    dec = kimi_lm.Decoder(params, TINY, enc, start_id=START, beam_size=K,
                          max_steps=T)
    gen = torch.Generator().manual_seed(5)
    words = torch.randint(1, 95, (B, K, T), generator=gen)
    seqs = torch.cat([torch.full((B, K, 1), START), words], -1)
    got = [dec.first[:, None].expand(B, K, -1)]
    table = torch.zeros((B * K, T), dtype=torch.int32)
    for j in range(T - 1):
        logits, table = dec.step(words[:, :, j].reshape(-1), table, j)
        got.append(logits.view(B, K, -1))
    got = torch.stack(got, 2)                               # (B, K, T, V)
    want, _ = _ref(params).teacher_forced(
        enc.repeat_interleave(K, 0), None, seqs.reshape(B * K, -1), T)
    torch.testing.assert_close(got.reshape(B * K, T, -1), want,
                               atol=LOGIT_TOL, rtol=1e-5)
    assert float(want.std()) > 1.0          # the head is not flat


def test_absorbed_attention_equals_the_decompressed_one():
    """One layer's attention at the last position: the port's absorbed
    form (W_UK into the query, the latent cache, W_UV out) against the
    reference's per-head keys and values."""
    params, _ = _setup(seed=3)
    lp = params["layers"]["1"]
    S, cfg = 9, TINY
    x = torch.randn((1, S, cfg.hidden_size),
                    generator=torch.Generator().manual_seed(4))
    want = _ref(params).attention(lp, x)[0, -1]
    cos, sin = kimi_lm.rope_tables(cfg, torch.arange(S))
    q = lm_cuda.linear(x[0], lp["q_w"])
    lat = lm_cuda.latent_rope(q, lm_cuda.linear(x[0], lp["kv_a_w"]),
                              lp["kv_norm"], cos, sin, cfg)
    # the first 5 positions as an image's prefix, the rest as the suffix
    P = 5
    prefix = torch.zeros((1, 16, cfg.latent_dim))
    prefix[0, :P] = lat[:P]
    slots = lat[P:]
    table = torch.arange(S - P, dtype=torch.int32)[None]
    wuk = kimi_lm.absorbed(params, cfg)[1]
    qlat = lm_cuda.absorb_query(q[-1:], wuk, cfg)
    olat = lm_cuda.mla_plain(qlat, q[-1:], prefix, P, slots, table, S - P,
                             cfg)
    got = lm_cuda.linear(lm_cuda.absorb_output(olat, lp["kv_b_w"], cfg),
                         lp["o_w"])[0]
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def _moe_by_token(h, lp, cfg):
    """The mixture one token at a time: sigmoid scores, the top k of
    score + bias by a scan that keeps the first of equal values, the
    unbiased weights normalised and scaled, each chosen expert and the
    shared expert."""
    E, k, F = cfg.n_routed_experts, cfg.num_experts_per_tok, \
        cfg.moe_intermediate_size
    out = torch.zeros_like(h)
    chosen = []
    for t in range(h.shape[0]):
        s = torch.sigmoid(lp["router_w"] @ h[t])
        c = (s + lp["router_bias"]).tolist()
        ids = []
        for _ in range(k):
            best = max((e for e in range(E) if e not in ids),
                       key=lambda e: (c[e], -e))
            ids.append(best)
        w = s[ids] / (s[ids].sum() + 1e-20) * cfg.routed_scaling_factor
        chosen.append(ids)
        for e, we in zip(ids, w):
            gu = lp["gate_up_w"][e] @ h[t]
            out[t] += we * (lp["down_w"][e] @ (
                torch.nn.functional.silu(gu[0::2]) * gu[1::2]))
        for g in range(E, cfg.groups):
            gu = lp["gate_up_w"][g] @ h[t]
            out[t] += lp["down_w"][g] @ (torch.nn.functional.silu(gu[0::2])
                                         * gu[1::2])
    return out, torch.tensor(chosen)


def test_moe_equals_a_per_token_loop_with_ties_and_bias():
    """The mixture against a per-token loop; experts 3 and 5 share a router
    row (an exact tie for second place goes to 3), and the bias lifts
    expert 6 into the choice without entering its weight."""
    params, _ = _setup(seed=7)
    lp = dict(params["layers"]["2"])
    cfg = TINY
    w = lp["router_w"].clone()
    w[5] = w[3]
    lp["router_w"] = w
    h = torch.randn((12, cfg.hidden_size),
                    generator=torch.Generator().manual_seed(8))
    s = torch.sigmoid(h @ w.t())
    # expert 6's bias makes it every token's first choice, expert 1's the
    # second, whatever their scores
    bias = torch.full((8,), -2.0)
    bias[1], bias[3], bias[5], bias[6] = 4.0, 0.0, 0.0, 5.0
    lp["router_bias"] = bias
    ids, weights = lm_cuda.route_plain(h, w, bias, cfg)
    want, chosen = _moe_by_token(h, lp, cfg)
    assert torch.equal(ids.long(), chosen)
    assert (ids[:, 0] == 6).all() and (ids[:, 1] == 1).all()
    # the weights are the unbiased scores, normalised and scaled
    sw = s.gather(1, ids.long())
    torch.testing.assert_close(
        weights, sw / sw.sum(-1, keepdim=True) * cfg.routed_scaling_factor)
    got = lm_cuda.moe(h, lp, cfg)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    # the tie: without expert 6's lift, 3 and 5 tie for second; 3 wins
    bias[6] = -2.0
    ids, _ = lm_cuda.route_plain(h, w, bias, cfg)
    tied = (s[:, 3] == s[:, 5])
    assert tied.all()
    assert (ids[:, 1] == 3).all()
    want, chosen = _moe_by_token(h, dict(lp, router_bias=bias), cfg)
    assert torch.equal(ids.long(), chosen)


def test_slot_table_beam_equals_a_beam_that_copies_the_caches():
    """The decode through the slot table against the same beam whose state
    is every lane's whole suffix cache, reordered (copied) at every step:
    the same sequences, lengths and scores."""
    params, enc = _setup(seed=11, n=3)
    K, T, B = 3, 7, 3
    cfg = TINY
    out = caption_beam_search(params, cfg, enc, torch.zeros(B, 0),
                              start_id=START, end_id=END,
                              beam_cfg=BeamConfig(beam_size=K, max_steps=T))
    dec = kimi_lm.Decoder(params, cfg, enc, start_id=START, beam_size=K,
                          max_steps=T)
    L, D = cfg.num_hidden_layers, cfg.latent_dim
    ident = torch.arange(B * K * T, dtype=torch.int32).view(B * K, T)
    calls = [0]

    def step_fn(state, prev_words):
        n = calls[0]
        calls[0] += 1
        if n == 0:
            v, i = lm_cuda.head_topk(dec.first, K)
            return (v[:, None].expand(B, K, K), i[:, None].expand(B, K, K)), \
                state, {}
        dec.slots = state["cache"].permute(2, 0, 1, 3, 4).reshape(
            L, B * K * T, D).clone()
        logits, _ = dec.step(prev_words.reshape(-1), ident, n - 1)
        v, i = lm_cuda.head_topk(logits, K)
        cache = dec.slots.view(L, B, K, T, D).permute(1, 2, 0, 3, 4)
        return (v.view(B, K, K), i.view(B, K, K)), {"cache": cache}, {}

    init = {"cache": torch.zeros((B, K, L, T, D))}
    want = beam.beam_search(step_fn, init, batch_size=B, beam_size=K,
                            vocab_size=cfg.vocab_size, start_id=START,
                            end_id=END, max_steps=T, seq_len=T + 1)
    for key in ("sequences", "lengths", "scores", "completed_sequences",
                "completed_scores"):
        assert torch.equal(out[key], want[key]), key


def test_caption_engine_serves_the_decoder_without_a_tagger():
    """CaptionEngine.caption_batch on uint8 images: a ResNet-50 grid (2 x 2
    x 2,048) into the language model, no tagger in the state."""
    cfg = dataclasses.replace(TINY, encoder_dim=2048, enc_image_size=2,
                              encoder_arch="resnet50")
    gen = torch.Generator().manual_seed(12)
    params = init_params(gen, cfg)
    enc_p, enc_s = encoders.init_encoder_caption(gen, "resnet50")
    state = {"params": params, "encoder": enc_p, "encoder_stats": enc_s}
    words = {f"w{i}": i for i in range(1, 95)}
    words.update({"<pad>": 0, "<start>": START, "<end>": END})
    eng = CaptionEngine(state, cfg, words,
                        ServeConfig(batch_buckets=(2,), max_steps=5),
                        device="cpu")
    images = np.random.default_rng(0).integers(0, 256, (3, 3, 32, 32),
                                               dtype=np.uint8)
    caps = eng.caption_batch(images)
    assert len(caps) == 3 and all(isinstance(c, str) for c in caps)
    assert all(w.startswith("w") for c in caps for w in c.split())
    assert eng.stats.decode_impls == ["lm_cache", "lm_cache"]


def test_the_plain_reference_imports_neither_jax_nor_the_ports_ops():
    code = ("import sys; sys.path.insert(0, 'tests')\n"
            "import plain_kimi_lm\n"
            "sys.path.insert(0, '.')\n"
            "import portbench.reference.kimi_lm\n"
            "print(sorted(sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    mods = out.stdout.strip().splitlines()[-1]
    assert "'jax'" not in mods and "jaxlib" not in mods
    assert "indonesian_image_captioning_tpu" not in mods


def test_the_benchmarks_copy_is_the_reference():
    ours = (ROOT / "tests" / "plain_kimi_lm.py").read_text()
    theirs = (ROOT / "portbench" / "reference" / "kimi_lm.py").read_text()
    assert ours == theirs
