"""Tagger evaluation CLI:
``python -m indonesian_image_captioning_tpu_torch.cli.eval_tagger``.

Counterpart of the JAX package's ``cli/eval_tagger.py``, with the same
flags and defaults (the reference's eval_tagger.py has module constants,
its :13-21, and no argparse).  It runs on the card (no device flag, as in
JAX) and reads the TEST split from the artifact files, which needs
``h5py``.
"""

from __future__ import annotations

import argparse

from ..core.config import DataConfig
from ..evaluation import eval_tagger as eval_lib
from .common import load_tagger_state


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Eval Image Tagger (CUDA)")
    p.add_argument("--model_tagger", "-mt",
                   default="BEST_checkpoint_tagger_flickr10k_5_cap_per_img_5_min_word_freq",
                   help="path to tagger checkpoint")
    p.add_argument("--data_folder", "-df", default="./scn_data")
    p.add_argument("--data_name", "-dn",
                   default="flickr10k_5_cap_per_img_5_min_word_freq")
    p.add_argument("--batch_size", "-bs", default=32, type=int)
    return p


def main(argv=None, device="cuda"):
    args = build_parser().parse_args(argv)
    params, stats = load_tagger_state(args.model_tagger, device=device)
    data_cfg = DataConfig(data_folder=args.data_folder,
                          data_name=args.data_name)
    return eval_lib.evaluate(params, stats, data_cfg,
                             batch_size=args.batch_size, device=device)


if __name__ == "__main__":
    main()
