"""mfu.caption: the model FLOPs of the captions the window completed, over
the window's seconds times the card's bf16 peak (989 TFLOP/s): per image
the decoder's hoisted projections, and per beam row alive at a step its
attention, cell and head (``work.decode_flops``); where the cell encodes
images, both ResNet-152s' convolutions and the tagger's head too."""

from portbench import work


def read(facts):
    if facts.get("kind") not in ("decode", "images"):
        return None
    flops = work.decode_flops(facts["model"], facts["captions"],
                              facts["row_steps"])
    flops += facts["captions"] * facts.get("encoder_flops", 0)
    return 100.0 * flops / (facts["window_s"]
                            * work.PEAK_OPS_S["bfloat16"])
