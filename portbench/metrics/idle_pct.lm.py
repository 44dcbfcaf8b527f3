"""idle_pct.lm: the share of the traced window in which no operation ran
on the device (1 - busy seconds / window seconds), in the language
model's decode cells."""


def read(facts):
    if facts.get("kind") != "lm_decode" or not facts.get("busy_s"):
        return None
    return 100.0 * (1.0 - facts["busy_s"] / facts["window_s"])
