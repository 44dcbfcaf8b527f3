"""Preprocessing CLI: ``python -m
indonesian_image_captioning_tpu_torch.cli.create_input_files``.

Counterpart of the JAX package's ``cli/create_input_files.py``, with the
same flags and defaults (the reference's create_input_files.py:5-36
surface).  It runs on the CPU (``data/preprocess.py``).
"""

from __future__ import annotations

import argparse

from ..data.preprocess import create_input_files


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="[Indonesian Image Captioning] -- Create Input Files")
    p.add_argument("--dataset", "-d", help="type of dataset")
    p.add_argument("--split_path", "-s", help="split path (karpathy)")
    p.add_argument("--image_folder", "-if", help="path to image folder")
    p.add_argument("--output_folder", "-of", help="path to output folder")
    p.add_argument("--captions_per_image", "-cpi", default=5, type=int)
    p.add_argument("--min_word_freq", "-mwf", default=5, type=int)
    p.add_argument("--max_len", "-ml", default=50, type=int)
    p.add_argument("--tag_size", default=1000, type=int)
    p.add_argument("--workers", "-w", default=0, type=int,
                   help="concurrent image decoders (0 = auto, 1 = serial); "
                        "artifacts are identical for every value")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    print("Creating input files...")
    create_input_files(dataset=args.dataset, split_path=args.split_path,
                       image_folder=args.image_folder,
                       captions_per_image=args.captions_per_image,
                       min_word_freq=args.min_word_freq,
                       output_folder=args.output_folder,
                       tag_size=args.tag_size, max_len=args.max_len,
                       workers=args.workers)
    print("Input files created!")


if __name__ == "__main__":
    main()
