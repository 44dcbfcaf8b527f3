"""A run driven on the CPU, the look for a card skipped, at the published
widths and a small batch, with the cells' own limits: sound, it comes out
correct where the program's CPU path reads as the card's does; with a
fault planted under the timed path (``portbench/faults.py``), or with the
control (the reference in float8 judged in the program's place), it
comes out not correct.  About a minute on one core."""

import pytest
import torch

from portbench import faults, run

DECODE = {"mix": {"batch": 8, "sample": 8, "warm_calls": 0}}
TRAIN = {"mix": {"batch": 32, "ref_block": 32}}
# the images cell with a ResNet-50 at 64 px served in float32: the CPU's
# bf16 convolutions part from the reference's far more than the card's
IMAGES = {"config": {"model": {"encoder_arch": "resnet50"},
                     "serve": {"dtype": "float32"}},
          "mix": {"batch": 4, "image_size": 64, "calibration_images": 8,
                  "buckets": [4], "sample": 4, "warm_calls": 0}}


def _run(workload, overrides, fault=None, control=False, seed=4100000123):
    args = run.parse(["--workload", workload, "--seed", str(seed),
                      "--seconds", "0", "--trace", "0"])
    result, _, _ = run.execute(args, device=torch.device("cpu"),
                               overrides=overrides,
                               fault=fault and faults.FAULTS[fault],
                               control=control)
    return result


@pytest.mark.parametrize("workload", ["scn.decode.b2048",
                                      "sat.decode.b2048"])
def test_a_sound_decode_is_correct(workload):
    result = _run(workload, DECODE)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0


@pytest.mark.parametrize("workload", ["scn.decode.b2048",
                                      "sat.decode.b2048"])
def test_an_altered_token_is_not_correct(workload):
    result = _run(workload, DECODE, fault="altered_token")
    assert not result["correct"]
    assert result["checks"]["gap"]["value"] > \
        result["checks"]["gap"]["limit"]


@pytest.mark.parametrize("workload", ["scn.decode.b2048",
                                      "sat.decode.b2048"])
def test_the_decode_control_is_not_correct(workload):
    assert not _run(workload, DECODE, control=True)["correct"]


def test_a_sound_train_step_keeps_the_numbers_the_faults_break():
    """grad and change within their limits.  The loss is the card's
    number: the CPU's bf16 eager scan and dense head read it about 2e-3
    from the reference at this size, where the card's kernels read
    under 1e-6 (PERF.md, PR 18)."""
    checks = _run("scn.train.b1024", TRAIN)["checks"]
    for number in ("grad", "change"):
        assert checks[number]["value"] <= checks[number]["limit"]


@pytest.mark.parametrize("fault,number", [("half_batch", "grad"),
                                          ("frozen", "change")])
def test_a_broken_train_step_is_not_correct(fault, number):
    result = _run("scn.train.b1024", TRAIN, fault=fault)
    assert not result["correct"]
    check = result["checks"][number]
    assert check["value"] > check["limit"]


def test_the_train_control_is_not_correct():
    assert not _run("scn.train.b1024", TRAIN, control=True)["correct"]


def test_images_to_captions_sound_broken_and_controlled():
    assert _run("scn.images.b256", IMAGES)["correct"]
    assert not _run("scn.images.b256", IMAGES,
                    fault="altered_token")["correct"]
    assert not _run("scn.images.b256", IMAGES, control=True)["correct"]
