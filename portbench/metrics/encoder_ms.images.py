"""encoder_ms.images: device milliseconds a batch of the two encoders
(the caption encoder and the tagger, ``models/encoders.py`` on
``models/resnet.py``): the kernels launched while the traced window's
regions around ``apply_encoder_caption`` and ``apply_encoder_tagger``
ran on the host, over the window's calls."""


def read(facts):
    spans = facts.get("span_device_s")
    if facts.get("kind") != "images" or not spans:
        return None
    secs = spans.get("portbench.encoder", 0.0) + \
        spans.get("portbench.tagger", 0.0)
    return 1e3 * secs / facts["calls"] if secs > 0 else None
