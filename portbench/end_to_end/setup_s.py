"""setup_s: seconds from the run's start (before torch is imported) to
the first timed unit: imports, the card's context, loading (and in a
fresh checkout building) the port's kernels, the seeded weights and
inputs, and the warm calls."""


def read(facts):
    return facts["setup_s"]
