"""mfu.lm_caption: the model FLOPs of the captions the window completed,
over the window's seconds times the card's bf16 peak (989 TFLOP/s): per
decode the projector and the prefill of every image's prefix, its first
head, and each cached step's live lanes (``work_kimi.decode_flops``)."""

from portbench import work, work_kimi


def read(facts):
    if facts.get("kind") != "lm_decode" or not facts.get("calls"):
        return None
    flops = facts["calls"] * work_kimi.decode_flops(
        facts["lm"], facts["batch"], facts["live"])
    return 100.0 * flops / (facts["window_s"]
                            * work.PEAK_OPS_S["bfloat16"])
