"""Train CLI: ``python -m indonesian_image_captioning_tpu_torch.cli.train``.

Counterpart of the JAX package's ``cli/train.py``, with the same flags and
defaults (reference train.py:5-21 surface: ``--type/-t`` dispatch; any
other type trains the image tagger, as the reference does).  The three
caption types go to ``train/caption.main`` and run on the card (JAX's CLI
takes its backend from the platform and has no device flag; neither does
this one).  ``--encoder_init`` loads a caption encoder state_dict in the
reference's layout.  Not ported yet, and raising ``NotImplementedError``
with the ROADMAP.md queue 1 item that ports it: the tagger trainer (the
fall-through, item 4), ``--mesh`` (item 7), ``--fine_tune_encoder``
(item 5) and ``--encoder_remat`` (items 4-5).
"""

from __future__ import annotations

import argparse
import dataclasses

from ..core.config import DataConfig, TrainConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="[(S)how (A)ttend (T)ell - (S)emantic (C)ompositional "
                    "(N)etworks] - Train Script (CUDA)")
    p.add_argument("--type", "-t", help="train model type")
    p.add_argument("--data_folder", "-df", default="./scn_data")
    p.add_argument("--data_name", "-dn",
                   default="flickr10k_5_cap_per_img_5_min_word_freq")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch_size", "-bs", type=int, default=None)
    p.add_argument("--decoder_lr", type=float, default=None)
    p.add_argument("--checkpoint_dir", default=".")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--tagger_checkpoint", "-mt", default=None,
                   help="tagger checkpoint for SCN models")
    p.add_argument("--encoder_init", default=None,
                   help="torch resnet152 state_dict to init the encoder")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--fine_tune_encoder", action="store_true",
                   help="jointly fine-tune ResNet stages 2-4 (reference "
                        "fine_tune_encoder flag; not ported yet)")
    p.add_argument("--decoder_dtype", default=None,
                   choices=("float32", "bfloat16"),
                   help="mixed-precision decoder training: bfloat16 = "
                        "bf16 compute with f32 master weights "
                        "(TrainConfig.decoder_dtype; default float32)")
    p.add_argument("--encoder_dtype", default=None,
                   choices=("float32", "bfloat16"),
                   help="frozen-encoder/tagger forward dtype during caption "
                        "training (TrainConfig.encoder_dtype; default "
                        "bfloat16)")
    p.add_argument("--tagger_dtype", default=None,
                   choices=("float32", "bfloat16"),
                   help="mixed-precision tagger training "
                        "(TrainConfig.tagger_dtype)")
    p.add_argument("--encoder_remat", nargs="?", const="blocks",
                   default=None, choices=("blocks", "convs"),
                   help="rematerialise ResNet bottlenecks in the "
                        "differentiated encoder passes (tagger training / "
                        "--fine_tune_encoder; not ported yet)")
    p.add_argument("--cache_features", action="store_true",
                   help="precompute the frozen encoder/tagger outputs once "
                        "per unique image and reuse them every epoch "
                        "(TrainConfig.cache_features)")
    p.add_argument("--cache_dtype", default=None,
                   choices=("float32", "bfloat16"),
                   help="feature-cache storage dtype (bfloat16 halves the "
                        "cache memory at one rounding of the features)")
    p.add_argument("--device_images", default=None,
                   choices=("auto", "on", "off"),
                   help="keep each split's uint8 images resident on the "
                        "device and gather batch rows by index instead of "
                        "copying pixels every step "
                        "(TrainConfig.device_images; 'auto' keeps the host "
                        "loader when the split exceeds "
                        "TrainConfig.device_images_budget_gb)")
    p.add_argument("--head_impl", default=None,
                   choices=("auto", "dense", "chunked"),
                   help="vocab CE head: 'chunked' streams fc in vocab "
                        "tiles (no (B,T,V) logits); 'auto' (default) picks "
                        "it on CUDA when the logit tensor is >= 2^27 "
                        "elements")
    p.add_argument("--head_tile", type=int, default=None,
                   help="vocab-tile width for the chunked head (2048)")
    p.add_argument("--mesh", default=None, metavar="D,M",
                   help="device mesh as data,model axis sizes (not ported "
                        "yet)")
    p.add_argument("--mesh_order", default=None,
                   choices=("rowmajor", "colmajor"),
                   help="mesh device enumeration order")
    p.add_argument("--model_json", default=None,
                   help="JSON dict (inline or a file path) of ModelConfig / "
                        "TaggerConfig field overrides, e.g. "
                        '\'{"embed_dim": 256, "encoder_arch": "resnet50"}\'')
    return p


CAPTION_TYPES = ("pure_scn", "attention_scn", "pure_attention")


def _not_ported(args) -> None:
    """Raise for the flags whose paths are not ported yet."""
    if args.mesh:
        raise NotImplementedError(
            "--mesh: the multi-device trainer is not ported yet (ROADMAP.md "
            "queue 1 item 7)")
    if args.fine_tune_encoder:
        raise NotImplementedError(
            "--fine_tune_encoder: the fine-tune step is not ported yet "
            "(ROADMAP.md queue 1 item 5)")
    if args.encoder_remat:
        raise NotImplementedError(
            "--encoder_remat: the differentiated encoder passes are not "
            "ported yet (ROADMAP.md queue 1 items 4-5)")


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.type not in CAPTION_TYPES:
        # the reference falls through to the tagger for any other --type
        raise NotImplementedError(
            f"--type {args.type!r} trains the image tagger, which is not "
            "ported yet (ROADMAP.md queue 1 item 4)")
    _not_ported(args)
    data_cfg = DataConfig(data_folder=args.data_folder,
                          data_name=args.data_name)
    overrides = _load_model_json(args.model_json)
    tcfg = TrainConfig(checkpoint_dir=args.checkpoint_dir, seed=args.seed,
                       fine_tune_encoder=args.fine_tune_encoder)
    tcfg = _override(tcfg, args)
    from ..train import caption
    return caption.main(args.type, data_cfg, tcfg,
                        tagger_checkpoint=args.tagger_checkpoint,
                        encoder_init=args.encoder_init,
                        resume=args.resume, model_overrides=overrides)


def _load_model_json(spec):
    if not spec:
        return None
    import json
    import os
    if not spec.strip().startswith("{") and os.path.exists(spec):
        with open(spec) as f:
            return json.load(f)
    return json.loads(spec)


def _override(tcfg: TrainConfig, args) -> TrainConfig:
    kw = {}
    if args.epochs is not None:
        kw["epochs"] = args.epochs
    if args.batch_size is not None:
        kw["batch_size"] = args.batch_size
    if args.decoder_lr is not None:
        kw["decoder_lr"] = args.decoder_lr
    if getattr(args, "decoder_dtype", None):
        kw["decoder_dtype"] = args.decoder_dtype
    if getattr(args, "encoder_dtype", None):
        kw["encoder_dtype"] = args.encoder_dtype
    if getattr(args, "tagger_dtype", None):
        kw["tagger_dtype"] = args.tagger_dtype
    if getattr(args, "encoder_remat", None):
        kw["encoder_remat"] = args.encoder_remat
    if getattr(args, "cache_features", False):
        kw["cache_features"] = True
    if getattr(args, "cache_dtype", None):
        kw["cache_dtype"] = args.cache_dtype
    if getattr(args, "device_images", None):
        kw["device_images"] = args.device_images
    if getattr(args, "head_impl", None):
        kw["head_impl"] = args.head_impl
    if getattr(args, "head_tile", None):
        kw["head_tile"] = args.head_tile
    if getattr(args, "mesh", None):
        parts = tuple(int(x) for x in args.mesh.split(","))
        if len(parts) == 1:
            parts = (parts[0], 1)
        if len(parts) != 2 or parts[0] < 1 or parts[1] < 1:
            raise SystemExit(f"--mesh must be D or D,M with positive sizes, "
                             f"got {args.mesh!r}")
        kw["mesh_shape"] = parts
    if getattr(args, "mesh_order", None):
        kw["mesh_order"] = args.mesh_order
    return dataclasses.replace(tcfg, **kw) if kw else tcfg


if __name__ == "__main__":
    main()
