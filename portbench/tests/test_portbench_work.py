"""work.py's counts against counts worked out by hand at the published
widths (E = 2,048, A = D = Emb = F = 512, P = 196, S = 1,000, V =
6,763, K = 5, T = 51)."""

import pytest

from portbench import work

E, A, D, Emb, F, P, S, V = 2048, 512, 512, 512, 512, 196, 1000, 6763
SCN = work.Model("attention_scn", V)
SAT = work.Model("pure_attention", V)


def test_a_beam_row_step_of_each_family():
    att = 2 * (D * A + P * A + P * E + D * E)
    head = 2 * D * V
    scn_cell = 2 * ((Emb + E) * 4 * F + D * 4 * F + 2 * 4 * F * D)
    lstm_cell = 2 * (Emb + E + D) * 4 * D
    assert sum(work.decoder_step_flops(SCN)) == att + scn_cell + head
    assert sum(work.decoder_step_flops(SAT)) == att + lstm_cell + head
    assert sum(work.decoder_step_flops(SCN)) / 1e6 == pytest.approx(27.33,
                                                                    abs=0.01)
    assert sum(work.decoder_step_flops(SAT)) / 1e6 == pytest.approx(23.13,
                                                                    abs=0.01)


def test_a_caption_and_a_trained_image():
    hoisted = 2 * (P * E * A + 2 * S * 4 * F + E * D * 2)
    per_caption = hoisted + 5 * 51 * 27327488
    assert work.decode_flops(SCN, 1, 5 * 51) == per_caption
    assert per_caption / 1e9 == pytest.approx(7.39, abs=0.01)
    assert work.train_flops_per_image(SCN, 51) == 3 * (hoisted
                                                       + 51 * 27327488)
    assert work.train_flops_per_image(SCN, 51) / 1e9 == pytest.approx(
        5.45, abs=0.01)


def test_a_whole_decode_counts_its_inputs_once():
    """Weights, the encoder state and the carried rows once per decode;
    the embedding rows and the records every step."""
    B, K, T, isz = 2048, 5, 51, 2
    one, _ = work.decode_work(SCN, B, K, 1, isz)
    many, flops = work.decode_work(SCN, B, K, T, isz)
    per_step = isz * B * K * Emb + 12 * B * K
    assert many - one == (T - 1) * per_step
    step_bytes, step_flops = work.step_work(SCN, B, K, isz)
    pro_bytes, pro_flops = work.prologue_work(SCN, B, isz)
    assert flops == T * step_flops + pro_flops
    # the kernel's count adds the ReLU's add of relu(ea + dec) per pixel
    assert step_flops == B * K * (sum(work.decoder_step_flops(SCN))
                                  + P * A)
    assert pro_flops == B * hoisted_per_image()


def hoisted_per_image():
    return 2 * (P * E * A + 2 * S * 4 * F + E * D * 2)


def test_bounds_take_the_larger_side():
    assert work.bound_s(3.35e12, 0.0) == pytest.approx(1.0)
    assert work.bound_s(0.0, 989e12) == pytest.approx(1.0)
    assert work.bound_s(3.35e12, 989e12 * 2) == pytest.approx(2.0)
    # the train scan at B = 1,024: about 2.86 ms (chip_smoke's train_work)
    assert 1e3 * work.train_scan_bound_s(SCN, 1024, 51, 2, "bfloat16") == \
        pytest.approx(2.863, abs=0.002)
