"""Single-image inference CLI: caption, top-k tags and the attention grid.

``python -m indonesian_image_captioning_tpu_torch.cli.inference``;
counterpart of the JAX package's ``cli/inference.py``, with the same flags
(reference inference.py:52-165: ``--type --img --model_caption
--model_tagger --tag_map --tag_out_count --word_map --beam_size
--dont_smooth``, and ``--viz_out``).  It takes a local path or a URL,
prints the top tags and the caption, and writes the per-word attention
overlay as a PNG (``--viz_out``, default ``<img>.att.png``) for the
attention models.  It runs on the card (no device flag, as in JAX).

:func:`run` does the file work at its edges (the image read or download,
the PNG write); between them :func:`caption_image` takes the image as a
uint8 array: tagger -> the top ``tag_out_count`` tags, encoder -> beam
search with the alphas recorded (the "steps" rung, kernel 1 on the card)
-> the caption and its alphas.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional

import numpy as np
import torch

from ..core.config import BeamConfig, ModelConfig
from ..core.runtime import get_device
from ..core.tokens import END_TOKEN, PAD_ID, START_TOKEN
from ..data import vocab as vocab_lib
from ..decode.api import caption_beam_search
from ..models import encoders
from .common import load_caption_state


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="[(S)emantic (C)ompositional (N)ets + Attention] - "
                    "Generate Caption (CUDA)")
    p.add_argument("--type", "-t", help="model type")
    p.add_argument("--img", "-i", help="path to image (or URL)")
    p.add_argument("--model_caption", "-mc",
                   help="path to pretrained caption model")
    p.add_argument("--model_tagger", "-mt", default=None,
                   help="path to pretrained tagger model")
    p.add_argument("--tag_map", "-tm", help="path to tag map JSON")
    p.add_argument("--tag_out_count", "-toc", type=int, default=20)
    p.add_argument("--word_map", "-wm", help="path to word map JSON")
    p.add_argument("--beam_size", "-b", default=5, type=int)
    p.add_argument("--dont_smooth", dest="smooth", action="store_false",
                   help="do not smooth alpha overlay")
    p.add_argument("--viz_out", default=None,
                   help="write the attention grid PNG here (default: "
                        "<img>.att.png for attention models)")
    return p


def caption_image(state: Dict, cfg: ModelConfig, image_u8: np.ndarray,
                  word_map: Dict[str, int], *,
                  beam_cfg: BeamConfig = BeamConfig(),
                  rev_tag_map: Optional[Dict[int, str]] = None,
                  tag_out_count: int = 20, device="cuda") -> Dict:
    """One (3, S, S) uint8 image -> {"caption": str, "seq": the beam's ids
    (<start> and <end> included), "alphas": (len(seq), P) numpy or None,
    "decode_impl"} and, for the tag models given ``rev_tag_map``, "tags":
    the top ``tag_out_count`` (name, probability) pairs in the JAX CLI's
    ``np.argsort(-probs)`` order."""
    dev = device if isinstance(device, torch.device) else get_device(device)
    start_id, end_id = word_map[START_TOKEN], word_map[END_TOKEN]
    result: Dict = {}
    with torch.inference_mode():
        x = encoders.prep_images(torch.tensor(image_u8[None], device=dev))
        if cfg.uses_tags:
            tags = encoders.apply_encoder_tagger(
                state["tagger"], state["tagger_stats"], x, train=False,
                arch=cfg.encoder_arch)[0]
            if rev_tag_map is not None:
                probs = tags[0].cpu().numpy()
                top = np.argsort(-probs)[:tag_out_count]
                result["tags"] = [(rev_tag_map[int(i)], float(probs[i]))
                                  for i in top]
        else:
            tags = torch.zeros((1, cfg.semantic_dim), dtype=x.dtype,
                               device=dev)
        enc = encoders.apply_encoder_caption(
            state["encoder"], state["encoder_stats"], x, train=False,
            enc_image_size=cfg.enc_image_size, arch=cfg.encoder_arch)[0]
        out = caption_beam_search(
            state["params"], cfg, enc, tags, start_id=start_id,
            end_id=end_id, beam_cfg=beam_cfg,
            record_alphas=cfg.uses_attention)
    n = int(out["lengths"][0])
    seq = [int(w) for w in out["sequences"][0][:n].tolist()]
    rev_word_map = vocab_lib.invert(word_map)
    result["caption"] = " ".join(rev_word_map[w] for w in seq
                                 if w not in (start_id, end_id, PAD_ID))
    result["seq"] = seq
    result["alphas"] = (out["alpha"][0][:n].cpu().numpy()
                        if cfg.uses_attention else None)
    result["decode_impl"] = out["decode_impl"]
    return result


def run(args, device="cuda") -> dict:
    from ..data.preprocess import read_image
    from ..utils.url import download_file, is_absolute_path

    img_path = args.img
    if is_absolute_path(img_path):
        img_path = download_file(img_path)
    image = read_image(img_path)                    # (3, 256, 256) u8

    word_map = vocab_lib.load_json(args.word_map)
    cfg = ModelConfig(model_type=args.type, vocab_size=len(word_map))
    state = load_caption_state(args.model_caption, cfg, args.model_tagger,
                               device=device)
    rev_tag_map = (vocab_lib.invert(vocab_lib.load_json(args.tag_map))
                   if args.tag_map else None)
    got = caption_image(state, cfg, image, word_map,
                        beam_cfg=BeamConfig(beam_size=args.beam_size),
                        rev_tag_map=rev_tag_map,
                        tag_out_count=args.tag_out_count, device=device)
    result = {"image_path": img_path}
    if "tags" in got:
        result["tags"] = got["tags"]
        print("Predicted tags")
        for name, pv in result["tags"]:
            print(f"  {name}: {pv:.4f}")
    result["caption"] = got["caption"]
    print("Caption:", result["caption"])

    if cfg.uses_attention:
        from ..utils.visualize import visualize_att
        result["viz"] = visualize_att(
            img_path, got["seq"], got["alphas"], vocab_lib.invert(word_map),
            smooth=args.smooth, enc_image_size=cfg.enc_image_size,
            save_path=args.viz_out or (img_path + ".att.png"))
        print("Attention visualization written to", result["viz"])
    return result


def main(argv=None, device="cuda"):
    return run(build_parser().parse_args(argv), device=device)


if __name__ == "__main__":
    main()
