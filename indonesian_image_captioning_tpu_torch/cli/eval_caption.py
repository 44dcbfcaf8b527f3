"""Caption evaluation CLI:
``python -m indonesian_image_captioning_tpu_torch.cli.eval_caption``.

Counterpart of the JAX package's ``cli/eval_caption.py``, with the same
flags and defaults (reference eval_caption.py:168-190, minus its
NameError and format-string bugs).  It runs on the card (no device
flag, as in JAX) and reads the TEST split from the artifact files, which
needs ``h5py``; the scores include METEOR, which needs nltk.  ``--mesh
D,M`` evaluates over D x M ranks, one process per rank, as the train CLI
trains (``torchrun --nproc_per_node D*M``; ``DIST_BACKEND=gloo`` lets
ranks share a card): each data row decodes its block of every batch and
every rank scores the whole split.
"""

from __future__ import annotations

import argparse
import os

from ..core import meshes
from ..core.config import BeamConfig, DataConfig, ModelConfig
from ..data import vocab as vocab_lib
from ..evaluation import eval_caption as eval_lib
from .common import load_caption_state


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="[(S)how (A)ttend (T)ell - (S)emantic (C)ompositional "
                    "(N)etworks] - Eval Caption (CUDA)")
    p.add_argument("--type", "-t", help="model type")
    p.add_argument("--model_caption", "-mc",
                   help="path to pretrained caption model")
    p.add_argument("--model_tagger", "-mt", default=None,
                   help="path to pretrained tagger model")
    p.add_argument("--data_folder", "-df", default="./scn_data")
    p.add_argument("--data_name", "-dn",
                   default="flickr10k_5_cap_per_img_5_min_word_freq")
    p.add_argument("--word_map", "-wm", default=None,
                   help="path to word map JSON (default: from data folder)")
    p.add_argument("--beam_size", "-bs", default=5, type=int)
    p.add_argument("--batch_size", default=16, type=int,
                   help="images decoded per device batch")
    p.add_argument("--output_root", default="evaluation")
    p.add_argument("--mesh", default=None, metavar="D,M",
                   help="shard eval batches over a (data, model) mesh of "
                        "ranks (one process per rank under torchrun)")
    return p


def main(argv=None, device="cuda"):
    args = build_parser().parse_args(argv)
    mesh_shape = None
    if args.mesh:
        parts = tuple(int(x) for x in args.mesh.split(","))
        mesh_shape = parts if len(parts) == 2 else (parts[0], 1)
        meshes.initialize_distributed(
            backend=os.environ.get("DIST_BACKEND"), device=device)
        # the process group must hold the mesh before anything is loaded
        meshes.check_mesh_shape(mesh_shape)
    data_cfg = DataConfig(data_folder=args.data_folder,
                          data_name=args.data_name)
    wm_path = args.word_map or vocab_lib.wordmap_path(args.data_folder,
                                                      args.data_name)
    word_map = vocab_lib.load_json(wm_path)
    cfg = ModelConfig(model_type=args.type, vocab_size=len(word_map))
    state = load_caption_state(args.model_caption, cfg, args.model_tagger,
                               device=device)
    scores = eval_lib.evaluate(
        state, cfg, data_cfg, word_map,
        beam_cfg=BeamConfig(beam_size=args.beam_size),
        batch_size=args.batch_size, output_root=args.output_root,
        mesh_shape=mesh_shape, device=device)
    print("\nScore of {} model @ beam size of {} is {}.\n".format(
        args.type, args.beam_size, scores))
    return scores


if __name__ == "__main__":
    main()
