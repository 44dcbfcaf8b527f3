"""train_scan_roofline: the train scan's share of its roofline.

The least time of kernels 8 and 9 in one step (``work.train_scan_bound_s``:
the forward's and the backward's bounds added, at 989 TFLOP/s bf16 or
3.35 TB/s), times the window's steps, over the device seconds of the
kernels those two launch: the port's own CUDA kernels (namespace iic::)
other than kernel 14's embedding-gradient ones."""

from portbench import work

PREFIXES = ("void iic::", "iic::")
EXCLUDED = ("iic::embed_",)


def read(facts):
    if facts.get("kind") != "train" or "kernel_s" not in facts:
        return None
    secs = sum(s for name, s in facts["kernel_s"].items()
               if name.startswith(PREFIXES)
               and not any(x in name for x in EXCLUDED))
    if secs <= 0.0:
        return None
    m = facts["model"]
    bound = work.train_scan_bound_s(m, facts["batch"],
                                    m.max_caption_len - 1,
                                    work.ISZ[facts["dtype"]], facts["dtype"])
    return 100.0 * bound * facts["steps"] / secs
