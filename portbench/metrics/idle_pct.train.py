"""idle_pct.train: the share of the traced window in which no operation ran
on the device (1 - busy seconds / window seconds)."""


def read(facts):
    if facts.get("kind") != "train" or not facts.get("busy_s"):
        return None
    return 100.0 * (1.0 - facts["busy_s"] / facts["window_s"])
