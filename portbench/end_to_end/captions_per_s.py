"""captions_per_s: captions completed in the window over the window's
seconds, the window ending in a synchronise after its last call."""


def read(facts):
    if facts["unit"] != "captions":
        return None
    return facts["units"] / facts["window_s"]
