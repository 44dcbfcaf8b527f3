"""moe_roofline.lm: the mixture-of-experts layers' share of their
roofline.

The least time of every mixture layer of the window's decodes
(``work_kimi.moe_work``: each expert group's weights once a layer a call
-- the prefill once, each cached step once -- and each (token, group)
row in and out once; 6 x hidden x expert width operations a row), at
989 TFLOP/s bf16 or 3.35 TB/s, over the device seconds of the kernels
launched inside the program's mixture layer (``ops/lm_cuda.moe``: the
router, the dispatch, the gather, the grouped GEMM and the combine;
the traced window's region ``portbench.lm.moe``)."""

from portbench import work, work_kimi


def read(facts):
    if facts.get("kind") != "lm_decode":
        return None
    secs = (facts.get("span_device_s") or {}).get("portbench.lm.moe", 0.0)
    if secs <= 0.0:
        return None
    nbytes, flops = work_kimi.moe_work(facts["lm"], facts["batch"],
                                       facts["live"])
    return 100.0 * facts["calls"] * work.bound_s(nbytes, flops) / secs
