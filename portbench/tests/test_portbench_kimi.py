"""The language model's decode cell (``kimi.decode.b256``) at tiny widths
on the CPU: its seeded tree is the port's layout, a run's checks pass on
the port's float32 path and fail under both planted faults, and the work
counts add up to the published model.

    python -m pytest portbench/tests/test_portbench_kimi.py -q
"""

import json

import pytest
import torch

from indonesian_image_captioning_tpu_torch.models import kimi_lm
from portbench import faults_kimi, run, weights_kimi, work_kimi

TINY = dict(vocab_size=997, hidden_size=64, intermediate_size=128,
            moe_intermediate_size=32, num_hidden_layers=3,
            num_attention_heads=4, n_shared_experts=1, n_routed_experts=8,
            num_experts_per_tok=2, kv_lora_rank=32, qk_nope_head_dim=16,
            qk_rope_head_dim=16, v_head_dim=16)
MODEL = dict(vocab_size=997, encoder_dim=24, enc_image_size=3,
             max_caption_len=9)


def _published():
    from pathlib import Path
    root = Path(__file__).resolve().parents[2]
    return json.loads((root / "portbench" / "configs"
                       / "kimi_vl_a3b.bf16.json").read_text())


def test_layout_is_the_ports():
    keys = {**TINY, **MODEL, "first_k_dense_replace": 1}
    cfg = kimi_lm.KimiLMConfig.of(keys)
    ours = [(p, s) for p, s, _ in weights_kimi.layout(keys)]
    port = [(p, s) for p, s, _ in kimi_lm.param_layout(cfg)]
    assert ours == port
    assert [k for _, _, k in weights_kimi.layout(keys)] == \
        [k for _, _, k in kimi_lm.param_layout(cfg)]


def test_the_published_model_is_whole():
    """15.96 B parameters: the configuration cuts nothing."""
    c = _published()
    keys = {**c, "encoder_dim": 2048, "enc_image_size": 14}
    n = 0
    for path, shape, _ in weights_kimi.layout(keys):
        if path.startswith("projector"):
            continue
        size = 1
        for d in shape:
            size *= d
        n += size
    assert abs(n - 15.96e9) < 0.01e9
    assert c["reduced"] == [] and c["num_hidden_layers"] == 27
    assert c["n_routed_experts"] == 64 and c["vocab_size"] == 163840


def test_work_counts():
    """The mixture's least bytes a decode step are every expert group's
    weights once a layer (29.6 GB over 26 layers) and its operations 6 H F
    a row."""
    c = _published()
    keys = {**c, "encoder_dim": 2048, "enc_image_size": 14}
    b0, f0 = work_kimi.moe_work(keys, 256, [])
    b1, f1 = work_kimi.moe_work(keys, 256, [1280])
    assert abs((b1 - b0) - 26 * (66 * 3 * 2048 * 1408 * 2
                                 + 2 * 1280 * 8 * 2048 * 2)) < 1
    assert f1 - f0 == 26 * 6 * 2048 * 1408 * 1280 * 8
    mb, mf = work_kimi.mla_work(keys, 256, [1280])
    assert mb == 27 * 2 * (256 * 197 * 576 + 1280 * 576
                           + 1280 * 16 * (576 + 512))
    assert work_kimi.decode_flops(keys, 256, [1280] * 50) > 0


# the program at float32 against the float32 reference reads only its
# summation order; the card's limits are for bf16 at the published widths
LIMITS = {"lm_decode_batch": {"gap_median": 1e-4, "gap_mean": 1e-3,
                              "malformed": 0.0}}


def _execute(fault=None, control=False, seed=4294967311):
    args = run.parse(["--workload", "kimi.decode.b256", "--seed", str(seed),
                      "--seconds", "0"])
    over = {"config": {**TINY, "model": MODEL,
                       "serve": {"dtype": "float32", "max_steps": 8},
                       "limits": LIMITS},
            "mix": {"batch": 8, "sample": 8}}
    return run.execute(args, device=torch.device("cpu"), overrides=over,
                       fault=fault, control=control)


def test_a_float32_run_passes_its_checks():
    result, facts, checks = _execute()
    assert result["correct"], result["checks"]
    assert facts["kind"] == "lm_decode" and facts["captions"] == 8
    assert len(facts["live"]) == facts["steps"] - 1


@pytest.mark.parametrize("name", sorted(faults_kimi.FAULTS))
def test_each_planted_fault_fails_a_check(name):
    result, _, _ = _execute(fault=faults_kimi.FAULTS[name])
    assert not result["correct"], result["checks"]


def test_the_float8_control_fails_a_check():
    """The reference in float8 in the program's place, one pick a position
    (the token float8 ranks where the reference ranks the served one)."""
    result, _, _ = _execute(control=True)
    assert not result["correct"], result["checks"]
