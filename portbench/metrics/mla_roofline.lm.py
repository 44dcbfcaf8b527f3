"""mla_roofline.lm: the decode's latent attention's share of its
roofline.

The least time of the attention of every cached step and layer of the
window's decodes (``work_kimi.mla_work``: each image's prefix cache rows
once a layer a step for all its lanes, each live lane's suffix rows, its
queries and its output; the scores and P V), at 989 TFLOP/s bf16 or
3.35 TB/s, over the device seconds of the MLA decode kernel
(``csrc/lm.cu`` ``mla_decode_kernel``)."""

from portbench import work, work_kimi

KERNEL = "mla_decode_kernel"


def read(facts):
    if facts.get("kind") != "lm_decode" or "kernel_s" not in facts:
        return None
    secs = sum(s for name, s in facts["kernel_s"].items() if KERNEL in name)
    if secs <= 0.0:
        return None
    nbytes, flops = work_kimi.mla_work(facts["lm"], facts["batch"],
                                       facts["live"])
    return 100.0 * facts["calls"] * work.bound_s(nbytes, flops) / secs
