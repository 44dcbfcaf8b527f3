"""train_images_per_s: images through whole train steps (forward, loss,
backward, clamp, Adam) in the window over the window's seconds, the
window ending in a synchronise after its last step."""


def read(facts):
    if facts["unit"] != "train_images":
        return None
    return facts["units"] / facts["window_s"]
