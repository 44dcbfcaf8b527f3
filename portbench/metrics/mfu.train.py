"""mfu.train: the model FLOPs of the images the window trained (forward
and backward of the hoisted projections and the T scan steps with the
head, ``work.train_flops_per_image``), over the window's seconds times the
card's bf16 peak (989 TFLOP/s)."""

from portbench import work


def read(facts):
    if facts.get("kind") != "train":
        return None
    m = facts["model"]
    flops = facts["units"] * work.train_flops_per_image(
        m, m.max_caption_len - 1)
    return 100.0 * flops / (facts["window_s"]
                            * work.PEAK_OPS_S["bfloat16"])
