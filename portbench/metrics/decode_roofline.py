"""decode_roofline: the whole beam decode's share of its roofline.

The least time the card could take for one decode (``work.decode_work``:
the weights, the encoder state and the carried rows read once per decode
whatever number of calls implements it, the embedding rows of every step
and the records written; every step's operations at all K lanes, and the
prologue), at 989 TFLOP/s bf16 or 3.35 TB/s, times the decodes of the
window, over the device's busy seconds in the traced window.  The decode
cells run nothing but decodes, so every busy second is the decode's,
whichever kernels a later change runs it on."""

from portbench import work


def read(facts):
    if facts.get("kind") != "decode" or not facts.get("busy_s"):
        return None
    isz = work.ISZ[facts["dtype"]]
    nbytes, flops = work.decode_work(facts["model"], facts["batch"],
                                     facts["beam"], facts["steps"], isz)
    bound = work.bound_s(nbytes, flops, facts["dtype"])
    return 100.0 * bound * facts["calls"] / facts["busy_s"]
