"""Top-k tag table for one image (the reference's notebooks/tagger.ipynb).

    python -m indonesian_image_captioning_tpu_torch.examples.tagger_topk \\
        --img x.jpg --model_tagger <ckpt> --tag_map TAGMAP.json [--topk 20]

Counterpart of the JAX repository's ``examples/tagger_topk.py``, with the
same flags: a thin layer over ``cli/common.load_tagger_state`` and
``data/preprocess.read_image``.  It runs on the card (``main(argv,
device=...)`` takes another device).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..cli.common import load_tagger_state
from ..core.runtime import get_device
from ..data import vocab as vocab_lib
from ..data.preprocess import read_image
from ..models import encoders


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--img", "-i", required=True)
    p.add_argument("--model_tagger", "-mt", required=True)
    p.add_argument("--tag_map", "-tm", required=True)
    p.add_argument("--topk", type=int, default=20)
    return p


def main(argv=None, device="cuda"):
    args = build_parser().parse_args(argv)
    dev = get_device(device)
    params, stats = load_tagger_state(args.model_tagger, device=dev)
    rev_tag_map = vocab_lib.invert(vocab_lib.load_json(args.tag_map))
    image = torch.from_numpy(read_image(args.img)[None]).to(dev)
    with torch.inference_mode():
        probs = encoders.apply_encoder_tagger(
            params, stats, encoders.prep_images(image), train=False)[0]
    probs = probs[0].float().cpu().numpy()
    top = np.argsort(-probs)[: args.topk]
    width = max(len(rev_tag_map[int(i)]) for i in top)
    print(f"{'tag':<{width}}  prob")
    for i in top:
        print(f"{rev_tag_map[int(i)]:<{width}}  {probs[i]:.4f}")
    return [(rev_tag_map[int(i)], float(probs[i])) for i in top]


if __name__ == "__main__":
    main()
